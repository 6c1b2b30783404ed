"""The port's sharding rules (``repro_torch.distributed``) against
``repro.distributed``, and the sharded train step, on the CPU.

* Placements, exact: every parameter of the 10 archs at full width, on the
  16x16 and 2x16x16 meshes, FSDP on and off: the port's spec equals the
  reference's ``param_spec`` for the stacked leaf with the layer axis
  dropped (the reference reads only ``axis_names`` and ``shape``, so a
  stand-in object carries the mesh; its leaves come from
  ``jax.eval_shape``).  The same for the batch and cache specs at every
  shape cell.
* Local shapes: on the production meshes (a ``fake`` process group), each
  placed parameter's local shape equals the shape by arithmetic on the
  reference's spec.
* Hints: without an ambient mesh, or on a plain tensor, ``hint`` returns
  its input, so the plain forward is what it was (``test_torch_models.py``
  holds it to the reference at its tolerances).
* The sharded step on a 1x1 gloo mesh (``grad_shardings``, and with
  ``gather_weights_once``) gives the plain step's losses, grad norms and
  parameters bitwise, and both agree with the reference's jitted
  ``make_train_step`` at ``test_torch_train_step.py``'s tolerance.

Each test that starts a process group ends it in a finalizer: the test
workers are shared.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor

import repro.train as RT
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.distributed import sharding as RS
from repro.launch import specs as ref_specs
import repro_torch.train as PT
from repro_torch.configs import ARCH_IDS, get_config, shape_cells
from repro_torch.distributed import (BATCH, batch_spec, cache_spec,
                                     distribute_batch, distribute_model,
                                     hint, local_shape, param_shardings,
                                     param_spec, set_mesh, to_placements)
from repro_torch.launch import specs as port_specs
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     teardown)
from repro_torch.models import from_reference_params
from repro_torch.models.config import SHAPES
from test_torch_train import one_torch_thread, pair  # noqa: F401
from test_torch_train_step import RTOL

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
STACKED = ("blocks", "shared")


def stand_ins(mesh_name):
    """(the reference's mesh, the port's stand-in): names and sizes, no
    devices (an ``AbstractMesh`` has the reference's ``axis_names`` and
    ``shape``; the port reads ``mesh_dim_names`` and ``shape``)."""
    names, shape = MESHES[mesh_name]
    return (jax.sharding.AbstractMesh(shape, names),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


@pytest.fixture
def process_group():
    """Ends whatever default process group the test starts."""
    yield
    teardown()


_REF_PARAMS = {}


def ref_params(arch):
    if arch not in _REF_PARAMS:
        tree = ref_specs.params_specs(ref_config(arch))
        _REF_PARAMS[arch] = {
            ".".join(RS._path_names(path)): (path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return _REF_PARAMS[arch]


def ref_name(name):
    top, _, rest = name.partition(".")
    return (f"{top}.{rest.split('.', 1)[1]}", True) if top in STACKED \
        else (name, False)


def want_spec(rmesh, arch, name, fsdp):
    """The reference's spec of the port's parameter ``name``: its stacked
    leaf's, the layer axis dropped."""
    rname, stacked = ref_name(name)
    path, leaf = ref_params(arch)[rname]
    spec = tuple(RS.param_spec(rmesh, path, leaf, fsdp=fsdp))
    return spec[1:] if stacked and spec else spec


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh_name, fsdp):
    rmesh, pmesh = stand_ins(mesh_name)
    model = port_specs.params_specs(get_config(arch))
    names = set()
    for name, p in model.named_parameters():
        assert param_spec(pmesh, name, p, fsdp) == \
            want_spec(rmesh, arch, name, fsdp), name
        names.add(ref_name(name)[0])
    assert names == set(ref_params(arch))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch, mesh_name):
    rmesh, pmesh = stand_ins(mesh_name)
    rcfg, cfg = ref_config(arch), get_config(arch)
    for cell in shape_cells(arch):
        shape = SHAPES[cell]
        rin = ref_specs.input_specs(rcfg, shape)
        pin = port_specs.input_specs(cfg, shape)
        for key in ("batch", "cache"):
            if key not in rin:
                continue
            assert set(pin[key]) == set(rin[key])
            for k, leaf in rin[key].items():
                assert tuple(pin[key][k].shape) == leaf.shape
                assert pin[key][k].dtype == getattr(torch, leaf.dtype.name)
        if "tokens" in rin:
            assert tuple(pin["tokens"].shape) == rin["tokens"].shape
        if "batch" in rin:
            rb = RS.batch_shardings(rmesh, rin["batch"])
            for k in rin["batch"]:
                assert batch_spec(pmesh, pin["batch"][k]) == \
                    tuple(rb[k].spec), (cell, k)
        if "cache" in rin:
            rc = RS.cache_shardings(rmesh, rcfg, rin["cache"],
                                    shape.global_batch)
            for k in rin["cache"]:
                assert cache_spec(pmesh, cfg, k, pin["cache"][k],
                                  shape.global_batch) == \
                    tuple(rc[k].spec), (cell, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shapes_on_the_production_mesh(arch, mesh_name,
                                             process_group):
    from torch.distributed.tensor import distribute_tensor
    rmesh, _ = stand_ins(mesh_name)
    sizes = dict(rmesh.shape)
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    model = port_specs.params_specs(get_config(arch))
    shardings = param_shardings(mesh, model, fsdp=True)
    for name, p in model.named_parameters():
        want = want_spec(rmesh, arch, name, True)
        assert shardings[name] == to_placements(mesh, want), name
        placed = distribute_tensor(p, mesh, shardings[name])
        assert tuple(placed.to_local().shape) == \
            local_shape(mesh, want, p.shape), name
        assert tuple(placed.to_local().shape) == tuple(
            n // int(np.prod([sizes[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
            for n, e in zip(p.shape, want + (None,) * (p.dim() - len(want))))


def test_tuple_entry_shards_one_dim_over_two_mesh_dims():
    _, pmesh = stand_ins("2x16x16")
    from torch.distributed.tensor import Replicate, Shard
    spec = (("pod", "model"), None, "data")
    assert to_placements(pmesh, spec) == (Shard(0), Shard(2), Shard(0))
    _, one = stand_ins("16x16")
    w = torch.empty((384, 7168, 2048), device="meta")
    assert param_spec(one, "blocks.0.moe.we_gate", w) == \
        ("model", None, "data")
    assert to_placements(one, ("model", None, "data")) == (Shard(2),
                                                           Shard(0))
    assert to_placements(one, ()) == (Replicate(), Replicate())


def test_hint_is_the_identity_without_a_mesh(process_group):
    x = torch.randn(2, 3, 4)
    assert hint(x, BATCH, None, "model") is x
    mesh = make_host_mesh("cpu")
    with set_mesh(mesh):
        assert hint(x, BATCH, None, "model") is x     # a plain tensor


def _run_steps(arch, kind, batches, ocfg, n_micro):
    """The port's model of ``arch`` (the reference's weights), 3 steps:
    plain, or on a 1x1 gloo mesh with ``grad_shardings`` (``"shard"``) and
    ``gather_weights_once`` (``"gather"``)."""
    cfg, params, _ = pair(arch)
    model = from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mesh = None if kind == "plain" else make_host_mesh("cpu")
    try:
        sh = None
        if mesh is not None:
            sh = param_shardings(mesh, model, fsdp=True)
            distribute_model(model, mesh, sh)
        step = PT.make_train_step(cfg, ocfg, n_micro=n_micro,
                                  grad_shardings=sh,
                                  gather_weights_once=kind == "gather")
        opt = PT.init_opt(ocfg, model, device="cpu")
        metrics = []
        with set_mesh(mesh):
            for b in batches:
                b = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
                if mesh is not None:
                    b = distribute_batch(b, mesh)
                model, opt, m = step(model, opt, b)
                assert not isinstance(m["loss"], DTensor)
                metrics.append((float(m["loss"]), float(m["grad_norm"]),
                                int(m["step"])))
        final = {n: (p.full_tensor() if mesh is not None else p).detach()
                 for n, p in model.named_parameters()}
        return metrics, final
    finally:
        teardown()


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-7b"])
def test_sharded_step_is_bitwise_the_plain_step(arch, n_micro):
    rcfg = ref_smoke(arch)
    data = RT.SyntheticLM(RT.DataConfig(seed=5, batch=4, seq_len=32), rcfg)
    batches = [{k: np.asarray(v) for k, v in data.batch_at(i).items()}
               for i in range(3)]
    ocfg = PT.OptimizerConfig(lr=1e-3, eps=1e-3)
    plain, pfinal = _run_steps(arch, "plain", batches, ocfg, n_micro)
    for kind in ("shard", "gather"):
        got, final = _run_steps(arch, kind, batches, ocfg, n_micro)
        assert got == plain, kind
        for n, w in pfinal.items():
            assert torch.equal(final[n], w), (kind, n)


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_sharded_step_matches_reference(arch):
    """The reference's jitted step from the same weights and batches;
    tolerances of ``test_torch_train_step.py``."""
    cfg, params, _ = pair(arch)
    rcfg = ref_smoke(arch)
    ocfg = dict(lr=1e-3, eps=1e-3)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.OptimizerConfig(**ocfg),
                                       n_micro=2))
    data = RT.SyntheticLM(RT.DataConfig(seed=5, batch=4, seq_len=32), rcfg)
    batches = [{k: np.asarray(v) for k, v in data.batch_at(i).items()}
               for i in range(3)]
    rstate = RT.init_opt(RT.OptimizerConfig(**ocfg), params)
    rparams, want = params, []
    for b in batches:
        rparams, rstate, rm = rstep(rparams, rstate, b)
        want.append((float(rm["loss"]), float(rm["grad_norm"])))
    for kind in ("shard", "gather"):
        got, final = _run_steps(arch, kind, batches,
                                PT.OptimizerConfig(**ocfg), 2)
        np.testing.assert_allclose([g[:2] for g in got], want, rtol=RTOL)
        for name, p in final.items():
            rname, stacked = ref_name(name)
            leaf = np.asarray(_leaf(rparams, rname))
            w = leaf[int(name.split(".")[1])] if stacked else leaf
            err = float(np.abs(p.numpy() - w).max())
            assert err <= RTOL * float(np.abs(leaf).max()), (kind, name)


def _leaf(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def _mesh_worker(rank, port, arch, kind, q):
    """One of 4 gloo processes: 3 steps of ``arch``'s smoke config on a
    2x2 ("data", "model") mesh; rank 0 sends the metrics and the
    parameters."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=4)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  seq_parallel=kind == "seq_parallel")
        got, final = _mesh_steps(cfg, mesh, kind)
        if rank == 0:
            q.put((got, final))
    except Exception as e:      # the parent reports it
        q.put(repr(e))
        raise
    finally:
        teardown()


def _mesh_steps(cfg, mesh, kind):
    """3 steps from ``init_params(cfg, 0)`` and ``SyntheticLM`` seed 5,
    4 x 32 tokens in 2 microbatches; on ``mesh`` when one is given."""
    from repro_torch.models import init_params
    ocfg = PT.OptimizerConfig(lr=1e-3, eps=1e-3)
    data = PT.SyntheticLM(PT.DataConfig(seed=5, batch=4, seq_len=32), cfg,
                          device="cpu")
    model = init_params(cfg, 0, device="cpu")
    sh = None
    if mesh is not None:
        sh = param_shardings(mesh, model, fsdp=True)
        distribute_model(model, mesh, sh)
    step = PT.make_train_step(cfg, ocfg, n_micro=2, grad_shardings=sh,
                              gather_weights_once=kind == "gather")
    opt = PT.init_opt(ocfg, model, device="cpu")
    got = []
    with set_mesh(mesh):
        for i in range(3):
            b = data.batch_at(i)
            if mesh is not None:
                b = distribute_batch(b, mesh)
            model, opt, m = step(model, opt, b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
    final = {n: (p.detach().full_tensor() if mesh is not None
                 else p.detach()).numpy()
             for n, p in model.named_parameters()}
    return got, final


@pytest.mark.parametrize("arch,kind", [
    ("yi-6b", "shard"), ("yi-6b", "gather"), ("yi-6b", "seq_parallel"),
    ("kimi-k2-1t-a32b", "shard"), ("mamba2-370m", "shard")])
def test_step_on_a_2x2_mesh_in_four_processes(arch, kind):
    """The step on a real 2x2 mesh (4 gloo processes: data and model
    shards of 2, every rule and hint in play; ``seq_parallel`` shards the
    residual stream over the sequence too) against the plain step from
    the same weights and batches: losses and grad norms within rtol 1e-5,
    parameters within 1e-5 of each one's largest |value| (fp32; the
    sums run in another order)."""
    import socket
    import torch.multiprocessing as mp
    from repro_torch.configs import get_smoke_config
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    procs = [ctx.Process(target=_mesh_worker, args=(r, port, arch, kind, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        res = q.get()
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert not isinstance(res, str), res
    got, final = res
    want, wfinal = _mesh_steps(get_smoke_config(arch), None, "plain")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for n, w in wfinal.items():
        assert np.abs(final[n] - w).max() <= RTOL * np.abs(w).max(), n
