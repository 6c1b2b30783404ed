"""The port's training substrate (``repro_torch.train``) against
``repro.train``, in fp32 on the CPU: the checkpoint of an optimizer state,
remat, the optimizer and the data pipeline (gradients:
``test_torch_grads.py``; the train step: ``test_torch_train_step.py``).

Each arch's reference weights are carried into the port with
``from_reference_params``; a reference tree shaped like the parameters
(gradients, moments) is carried the same way by ``port_named``.
Tolerances, each stated where it is used: gradients within 1e-5 of each
reference leaf's largest |gradient|; an optimizer step within rtol 1e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.ft.erasure as RE
import repro.models as R
import repro.train as RT
from repro.configs import get_smoke_config as ref_smoke
import repro_torch.ft.erasure as PE
import repro_torch.models as P
import repro_torch.train as PT
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.ft import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
from repro_torch.models.convert import _to_tensor, _walk
from test_torch_models import make_batch, to_torch

GRAD_TOL = 1e-5          # of the reference leaf's largest |gradient|
OPT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread in these modules: the suite runs in several
    worker processes on the host's cores, and each worker's own torch
    thread pool oversubscribes them (a loop test took 85 s instead of 4
    under load).  Imported by the other training and serving test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_named(tree):
    """A reference tree shaped like the parameters (stacked ``blocks`` and
    ``shared`` leaves) as {port parameter name: numpy array}."""
    out = {}
    for name, arr in _walk(tree):
        arr = np.asarray(arr)
        top, _, rest = name.partition(".")
        if top in ("blocks", "shared"):
            for i in range(arr.shape[0]):
                out[f"{top}.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0):
    """(cfg, reference params, the port's model holding them); the
    reference's init compiled (quicker than eager on the CPU)."""
    cfg = get_smoke_config(arch)
    params = jax.jit(R.init_params, static_argnums=0)(
        ref_smoke(arch), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, P.from_reference_params(cfg, tree, device="cpu")


def ref_leaves(tree):
    """{dotted reference name: numpy array} of a nested dict."""
    return {name: np.asarray(a) for name, a in _walk(tree)}


def port_grads(cfg, model, batch):
    model.zero_grad(set_to_none=True)
    loss = P.loss_fn(cfg, model, to_torch(batch))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def ref_grads(arch, params, batch):
    return jax.jit(jax.value_and_grad(
        lambda p, b: R.loss_fn(ref_smoke(arch), p, b)))(params, batch)


# -- C8: a NamedTuple through a checkpoint ----------------------------------

def _opt_state(mod, rng, momentum=True):
    m = {"w": rng.normal(size=(4, 3)).astype(np.float32)} if momentum else ()
    return mod.OptState(step=np.int32(5), m=m,
                        v={"w": {"row": rng.normal(size=(4,)).astype(
                            np.float32), "col": np.ones(3, np.float32)}})


@pytest.mark.parametrize("momentum", [True, False])
def test_checkpoint_keeps_the_optstate_namedtuple(momentum):
    """The port's tree_to_bytes gives the reference's bytes for a state
    holding an ``OptState``, and a restore (from the bytes, and through an
    erasure-coded checkpoint) gives back an ``OptState`` with the same
    leaves in the reference's order; an empty ``()`` first moment
    (Adafactor without momentum) survives."""
    def state(mod):
        rng = np.random.default_rng(3)
        return {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                           "b": np.arange(3, dtype=np.float32)},
                "opt": _opt_state(mod, rng, momentum), "step": np.int32(9)}

    ref_buf, ref_spec = RE.tree_to_bytes(state(RT))
    buf, spec = PE.tree_to_bytes(state(PT), device="cpu")
    assert buf.numpy().tobytes() == ref_buf.tobytes()
    ref_back = RE.bytes_to_tree(ref_buf, ref_spec)
    ckpt = ECCheckpoint(Fleet(FleetConfig(), seed=0),
                        ErasureCoder(blocks_per_host=2, device="cpu"),
                        hosts=list(range(8)))
    ckpt.save(state(PT), step=9)
    for back in (PE.bytes_to_tree(buf, spec), ckpt.restore()):
        assert type(back["opt"]) is PT.OptState
        assert type(ref_back["opt"]) is RT.OptState
        assert back["opt"]._fields == ref_back["opt"]._fields
        assert (back["opt"].m == ()) == (not momentum)
        got = [np.asarray(x) for x in PE.tree_flatten(back)[0]]
        want = jax.tree_util.tree_leaves(ref_back)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.tobytes() == np.asarray(b).tobytes()


# -- gradients and remat ------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-7b"])
def test_remat_changes_no_number(arch):
    """Loss and gradients bitwise equal with ``remat`` off, on with full
    recompute, and on with the ``dots`` policy."""
    cfg, _, model = pair(arch)
    batch = make_batch(cfg, 2, 32, seed=12)
    runs = []
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss, grads = port_grads(c, model, batch)
        runs.append((loss, {n: g.clone() for n, g in grads.items()}))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for name, g in grads.items():
            assert torch.equal(g, runs[0][1][name]), name


# -- the optimizer, one step ------------------------------------------------

def _rand_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=np.shape(p)) * 0.1).astype(np.float32)
        .astype(np.asarray(p).dtype), params)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m"])
@pytest.mark.parametrize("opt", [
    dict(mode="adamw"),
    dict(mode="adafactor"),
    dict(mode="adafactor", momentum=False),
    dict(mode="adamw", state_dtype="bfloat16", grad_clip=0.05),
], ids=["adamw", "adafactor", "adafactor-no-momentum", "adamw-bf16-clip"])
def test_one_optimizer_step_matches_reference(arch, opt):
    """``apply_updates`` at steps 1 and 2, each from the reference's
    parameters, state and gradients: new parameters and every moment
    within rtol 1e-6, plus 1e-6 of the compared leaf's largest |value|
    (the update p - lr * delta cancels where p is close to lr * delta, and
    there the packages' 1-ulp differences in delta, from torch's CPU sqrt,
    which is not correctly rounded, and reductions in another order, are
    ulps of the operands, not of the result); moments stored in bf16
    within one bf16 ulp.  Adafactor's stacked rank-2 leaves keep the
    reference's ``row`` (L,) and ``col`` (d,)."""
    ocfg = dict(lr=1e-2, **opt)
    rcfg, pcfg = RT.OptimizerConfig(**ocfg), PT.OptimizerConfig(**ocfg)
    cfg, params, _ = pair(arch)
    model = P.from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rstate = RT.init_opt(rcfg, params)
    pstate = PT.init_opt(pcfg, model, device="cpu")
    named = dict(model.named_parameters())
    stacked = {k for k, _, s in PT.optimizer.factor_groups(named) if s}
    assert stacked            # every smoke arch here has per-layer 1-D leaves
    if pcfg.mode == "adafactor":
        for leaf in stacked:
            top, _, rest = leaf.partition(".")
            L = cfg.num_layers if top == "blocks" else cfg.num_shared_blocks
            assert pstate.v[leaf]["row"].shape == (L,)
            assert pstate.v[leaf]["col"].shape == named[f"{top}.0.{rest}"].shape

    def leaves(rparams, rstate):
        """(port tensor, reference array, label) for every parameter and
        moment."""
        out = [(p.detach(), port_named(rparams)[n], n)
               for n, p in model.named_parameters()]
        if pcfg.momentum:
            out += [(pstate.m[n], m, f"m {n}")
                    for n, m in port_named(rstate.m).items()]
        else:
            assert pstate.m == () and rstate.m == ()
        if pcfg.mode == "adamw":
            return out + [(pstate.v[n], v, f"v {n}")
                          for n, v in port_named(rstate.v).items()]
        for ref_name, v in ref_leaves(rstate.v).items():
            leaf, part = ref_name.rsplit(".", 1)
            top, _, rest = leaf.partition(".")
            if leaf in stacked or top not in ("blocks", "shared"):
                out.append((pstate.v[leaf][part], v, f"v {ref_name}"))
            else:
                out += [(pstate.v[f"{top}.{i}.{rest}"][part], v[i],
                         f"v {ref_name}[{i}]") for i in range(v.shape[0])]
        return out

    rparams = params
    for step, seed in enumerate((1, 2), start=1):
        g = _rand_grads(params, seed)
        rparams, rstate = RT.apply_updates(rcfg, rparams, g, rstate)
        _, pstate = PT.apply_updates(
            pcfg, model, {n: torch.from_numpy(a.copy())
                          for n, a in port_named(g).items()}, pstate)
        assert int(pstate.step) == int(rstate.step) == step
        for got, want, what in leaves(rparams, rstate):
            assert got.shape == want.shape, what
            # a bf16 moment is the fp32 value rounded: a 1-ulp difference in
            # the fp32 value (clip from the global norm summed in another
            # order) can round to the neighbouring bf16 value, 2^-7 of it
            # at most
            rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else OPT_RTOL
            w32 = np.asarray(jnp.asarray(want, jnp.float32))
            np.testing.assert_allclose(
                got.float().numpy(), w32, rtol=rtol,
                atol=OPT_RTOL * np.abs(w32).max(), err_msg=f"{what}, {step}")
            got.copy_(_to_tensor(want))     # the next step from the same


def test_optimizer_state_layout():
    """AdamW's moments follow ``named_parameters()``; Adafactor groups
    exactly the per-layer rank-1 leaves."""
    cfg = get_smoke_config("zamba2-7b")
    model = P.init_params(cfg, 0, device="cpu")
    named = dict(model.named_parameters())
    st = PT.init_opt(PT.OptimizerConfig(), model, device="cpu")
    assert list(st.m) == list(named) and st.step.dtype == torch.int32
    groups = PT.optimizer.factor_groups(named)
    assert sorted(n for _, names, _ in groups for n in names) == sorted(named)
    for key, names, stacked in groups:
        assert stacked == (named[names[0]].dim() == 1
                           and key.split(".")[0] in ("blocks", "shared"))
        if stacked:
            assert len(names) > 1 or key.startswith("shared")
            assert names == sorted(names, key=lambda n: int(n.split(".")[1]))


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "pixtral-12b", "hubert-xlarge"])
def test_synthetic_data(arch):
    """The successor table is the reference's; ``batch_at`` is a pure
    function of (seed, step); keys, shapes, dtypes and the label masking of
    the frontends are the reference's."""
    cfg = get_smoke_config(arch)
    dcfg = dict(seed=4, batch=3, seq_len=40)
    ref = RT.SyntheticLM(RT.DataConfig(**dcfg), ref_smoke(arch))
    a = PT.SyntheticLM(PT.DataConfig(**dcfg), cfg, device="cpu")
    b = PT.SyntheticLM(PT.DataConfig(**dcfg), cfg, device="cpu")
    assert a.perm.tolist() == np.asarray(ref.perm).tolist()
    want = ref.batch_at(2)
    got = a.batch_at(2)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert torch.equal(got[key], a.batch_at(2)[key])
        assert torch.equal(got[key], b.batch_at(2)[key])
    assert not torch.equal(got["labels"], a.batch_at(3)["labels"])
    lab = got["labels"]
    if cfg.frontend == "patch_embed":
        n = cfg.num_frontend_tokens
        assert (lab[:, :n] == -1).all() and (lab[:, n:] >= 0).all()
    else:
        assert (lab >= 0).all() and (lab < cfg.vocab_size).all()
    if "tokens" in got:
        # the chain: labels are the next tokens, mostly perm's successors
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1]) or \
            cfg.frontend == "patch_embed"
        follows = (a.perm[got["tokens"].long()] == got["labels"]).float()
        assert float(follows[:, -20:].mean()) > 0.6
