"""The expert share of OLMoE's MoE (``models.moe.MoEShare``,
``MoEShareConfig``) on the CPU at small sizes, on seeded random weights:

  * the program against the benchmark's plain reference
    (``perfbench/reference/olmoe.py``): the loss, the router's losses and
    every leaf's gradient of a step of two microbatches;
  * a router skewed so that a capacity of 1.25 drops pairs: the dropless
    share computes them all and still equals the reference, the capacity
    rule drops some and does not;
  * the share: four shares of the experts, summed, equal the uncut
    reference layer (the layer that holds them all);
  * QK-norm against a norm written out by hand;
  * the dispatch's and the combine's gathers both ways agree with the
    same arithmetic through autograd's own index ops;
  * the olmoe and kimi-k2 smoke configurations' step gives the same bits
    as before the share was added (digests recorded from the parent
    tree's program);
  * the gathers' hand kernels (``kernels.moe_gather``): a CPU step takes
    the plain versions (counters ``moe.combine.plain``,
    ``moe.combine.fused``, ``moe.gather.launches``); the plain gather adds
    a token's pairs in k order, the order the kernel follows; the wrapper
    refuses what the kernel does not take; the repair, planning and
    olmo-1b paths never import it; the card's gate
    (``kernels.gates.moe_gather_against_plain``) passes stand-ins of the
    plain versions and refuses one a bit off.

On the card (marked ``chip``, skipped without one): the kernels against
the plain versions by ``kernels.gates.moe_gather_against_plain`` (which
``chip_smoke.py`` calls too) at OLMoE's microbatch (T 8,192, K 8, d
2,048, 16 of 64 experts held) under the benchmark's router and a skewed
one, with ``share_plan``'s plan and ``capacity_plan``'s (drops), and at
small odd shapes (fp32 rows, d not a multiple of 8, K past 8): y, gx and
gye bitwise, gg within 2**-17 of |gy| . |row| (a d-term dot product
summed in another order), a graph replay bitwise the eager calls; a CUDA
step's counters; a ``TrainGraph`` of the share bitwise the eager step.

Tolerances: fp32 against fp32 on the CPU, sums in another order (the
program sums a token's experts over its top K, the reference in the
experts' order): rtol 1e-4, atol 1e-5 as in ``test_torch_models.py``.
"""
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import gen_moe                                   # noqa: E402
from perfbench.reference import olmoe as ref                    # noqa: E402
from perfbench.tools.faults_moe import (capacity_drop,          # noqa: E402
                                        capacity_plan)
from repro_torch.configs import get_smoke_config                # noqa: E402
from repro_torch.models import (MoEShareConfig, Transformer,    # noqa: E402
                                init_params, loss_terms)
from repro_torch.models import moe as moe_mod                   # noqa: E402
from repro_torch.kernels import gates                           # noqa: E402
from repro_torch.kernels import moe_gather as kmg               # noqa: E402
from repro_torch.models.layers import apply_norm, rope          # noqa: E402
from repro_torch.obs import spans                               # noqa: E402
from repro_torch.train import (EagerTrainStep,                 # noqa: E402
                               OptimizerConfig, TrainGraph, init_opt,
                               make_train_step)

from test_torch_train import one_torch_thread                   # noqa: E402,F401

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(name="olmoe-share-smoke", family="moe", num_layers=2,
             d_model=64, d_ff=32, vocab_size=256, num_heads=4,
             num_kv_heads=4, head_dim=16, norm="rmsnorm",
             rope_theta=10000.0, tie_embeddings=False, num_experts=4,
             experts_per_token=4, router_experts=8, expert_offset=2,
             norm_eps=1e-5, lb_weight=0.01, z_weight=0.001,
             param_dtype="float32", compute_dtype="float32", q_chunk=16,
             kv_chunk=16, loss_chunk=16)


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.reset()
    yield
    spans.reset()


def model_of(mdl, seed=3):
    cfg = MoEShareConfig(**mdl)
    model = Transformer(cfg, "cpu")
    w = gen_moe.moe_weights(mdl, seed, "cpu", torch.float32)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return cfg, model, w


def batch_of(vocab, rows=4, seq=16, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, vocab, (rows, seq), generator=g),
            torch.randint(0, vocab, (rows, seq), generator=g))


def program_step(cfg, model, tokens, labels, n_micro):
    """The loss parts (means over the microbatches) and the gradients (the
    mean of the microbatches'), as ``make_train_step`` takes them."""
    rows = tokens.shape[0] // n_micro
    parts = {}
    for mb in range(n_micro):
        sl = slice(mb * rows, (mb + 1) * rows)
        terms = loss_terms(cfg, model, {"tokens": tokens[sl],
                                        "labels": labels[sl]})
        terms["loss"].backward()
        for k, v in terms.items():
            parts[k] = parts.get(k, 0.0) + float(v.detach()) / n_micro
    grads = {n: p.grad / n_micro for n, p in model.named_parameters()}
    return parts, grads


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("held, offset", [(4, 2), (2, 6), (8, 0)])
def test_step_matches_the_reference(held, offset):
    mdl = dict(SMALL, num_experts=held, expert_offset=offset)
    cfg, model, w = model_of(mdl)
    tokens, labels = batch_of(mdl["vocab_size"])
    parts, grads = program_step(cfg, model, tokens, labels, 2)
    want, want_grads, _ = ref.loss_and_grads(w, mdl, tokens, labels, 2)
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        close(parts[k], want[k], k)
    assert parts["lb_loss"] > 0 and parts["z_loss"] > 0
    for n, g in grads.items():
        close(g.numpy(), want_grads[n].numpy(), n)
    assert spans.device_total("moe.dropped") == 0


def skewed(mdl, seed=3):
    """A model whose routers favour the held experts 2 and 3, so that a
    capacity of 1.25 T K / E drops pairs there."""
    cfg, model, w = model_of(mdl, seed)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            blk.moe.router[:, 2:4] += 3.0 * blk.moe.router[:, :1].sign()
            w[f"blocks.{i}.moe.router"] = blk.moe.router.detach().clone()
    return cfg, model, w


def test_skewed_router_dropless_against_capacity():
    mdl = dict(SMALL, num_experts=4, expert_offset=0, experts_per_token=2)
    tokens, labels = batch_of(mdl["vocab_size"])
    cfg, model, w = skewed(mdl)
    want, want_grads, _ = ref.loss_and_grads(w, mdl, tokens, labels, 1)
    parts, grads = program_step(cfg, model, tokens, labels, 1)
    close(parts["loss"], want["loss"], "dropless loss")
    for n, g in grads.items():
        close(g.numpy(), want_grads[n].numpy(), n)
    assert spans.device_total("moe.dropped") == 0
    kept = spans.device_total("moe.pairs")

    cfg, model, _ = skewed(mdl)
    with capacity_drop():
        parts, _ = program_step(cfg, model, tokens, labels, 1)
    dropped = spans.device_total("moe.dropped")
    assert dropped > 0 and spans.device_total("moe.pairs") > kept
    assert abs(parts["loss"] - want["loss"]) > 1e-4 * abs(want["loss"])


def test_four_shares_sum_to_the_uncut_layer():
    E, K = 8, 3
    whole = dict(SMALL, num_experts=E, router_experts=E, expert_offset=0,
                 experts_per_token=K, num_layers=1)
    cfg, model, w = model_of(whole)
    layer = model.blocks[0].moe
    x = torch.randn(2, 16, whole["d_model"], generator=torch.Generator()
                    .manual_seed(9))
    with torch.no_grad():
        y_ref, *_ = ref.moe_share(x.reshape(-1, whole["d_model"]), w,
                                  "blocks.0.moe.", whole)
        total = torch.zeros_like(x)
        counted = 0
        for part in range(4):
            mdl = dict(whole, num_experts=E // 4, expert_offset=part * E // 4)
            share = moe_mod.MoEShare(MoEShareConfig(**mdl), "cpu")
            sl = slice(part * E // 4, (part + 1) * E // 4)
            share.router.copy_(layer.router)
            for name in ("we_gate", "we_up", "we_down"):
                getattr(share, name).copy_(getattr(layer, name)[sl])
            y, _, counts = share.forward_stats(x)
            total += y
            counted += int(counts[0])
        y_whole, _, counts = layer.forward_stats(x)
    close(total.numpy(), y_ref.reshape(x.shape).numpy(), "shares summed")
    close(y_whole.numpy(), y_ref.reshape(x.shape).numpy(), "uncut layer")
    assert counted == int(counts[0]) == x.shape[0] * x.shape[1] * K


def test_qk_norm_against_a_hand_norm():
    cfg, model, w = model_of(SMALL)
    attn = model.blocks[0].attn
    x = torch.randn(2, 8, SMALL["d_model"], generator=torch.Generator()
                    .manual_seed(4))
    pos = torch.arange(8, dtype=torch.int32)
    with torch.no_grad():
        q, k, _ = attn.qkv(x, pos)
        d, H, hd = SMALL["d_model"], SMALL["num_heads"], SMALL["head_dim"]
        for got, wname, nname in ((q, "wq", "q_norm"), (k, "wk", "k_norm")):
            p = x @ w[f"blocks.0.attn.{wname}"].reshape(d, H * hd)
            p = p / torch.sqrt((p * p).mean(-1, keepdim=True) + 1e-5) \
                * w[f"blocks.0.attn.{nname}"]
            want = rope(p.reshape(2, 8, H, hd), pos, SMALL["rope_theta"])
            close(got.numpy(), want.numpy(), nname)
        # the reference package's configurations have no QK-norm
        plain = get_smoke_config("olmoe-1b-7b")
        assert not hasattr(Transformer(plain, "cpu").blocks[0].attn,
                           "q_norm")
    assert apply_norm("rmsnorm", x, torch.ones(d), eps=1e-5).shape == x.shape


def test_dispatch_and_combine_gathers_are_the_plain_sums():
    """``_Dispatch`` and ``_Combine`` (gathers both ways, sums over K)
    against the same arithmetic through autograd's own index ops."""
    g = torch.Generator().manual_seed(2)
    T, K, held, d = 12, 3, 4, 8
    top = torch.stack([torch.randperm(8, generator=g)[:K] for _ in range(T)])
    row, valid, pair, offs, counts = moe_mod.share_plan(top, 2, held)
    R = pair.shape[0]
    x = torch.randn(T, d, generator=g, requires_grad=True)
    gates = torch.rand(T, K, generator=g, requires_grad=True)
    xs = moe_mod._Dispatch.apply(x, pair, row, valid)
    ye = xs * 2.0 + 1.0
    y = moe_mod._Combine.apply(ye, gates, row, valid, pair)
    gy = torch.randn(T, d, generator=g)
    gx, gg = torch.autograd.grad(y, (x, gates), gy)

    x2 = x.detach().clone().requires_grad_(True)
    g2 = gates.detach().clone().requires_grad_(True)
    ye2 = x2[pair // K] * 2.0 + 1.0
    at = torch.clamp(row, max=R - 1)
    y2 = torch.zeros(T, d)
    for k in range(K):
        y2 = y2 + torch.where(valid[:, k, None],
                              g2[:, k, None] * ye2[at[:, k]], 0.0)
    gx2, gg2 = torch.autograd.grad(y2, (x2, g2), gy)
    close(y.detach().numpy(), y2.detach().numpy(), "combine")
    close(gx.numpy(), gx2.numpy(), "dispatch's gradient")
    close(gg.numpy(), gg2.numpy(), "gates' gradient")
    assert int(offs[-1]) == int(valid.sum()) == int(counts[0])
    assert int(counts[1]) == 0


# (loss, grad norm, sha256 of every parameter after the step), recorded
# from the program before the share was added: make_train_step with 2
# microbatches, AdamW's defaults, init_params(cfg, 3), a (2, 32) batch
# drawn by numpy's default_rng(11), one torch thread
BEFORE = {
    "olmoe-1b-7b": ("0x1.8849260000000p+2", "0x1.fb19c80000000p+1",
                    "a00125e821e72fd8dedc32f7d0c15d8d"),
    "kimi-k2-1t-a32b": ("0x1.8551540000000p+2", "0x1.1e3c9e0000000p+2",
                        "4024fb54dc80d1cf31f4db342b866757"),
}


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_capacity_moe_step_is_bitwise_as_before(arch):
    cfg = get_smoke_config(arch)
    assert not isinstance(cfg, MoEShareConfig)
    model = init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 32), np.int32)),
        "labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 32), np.int32))}
    oc = OptimizerConfig()
    _, _, m = make_train_step(cfg, oc, n_micro=2)(
        model, init_opt(oc, model, device="cpu"), batch)
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        h.update(n.encode())
        h.update(p.detach().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    assert set(m) == {"loss", "grad_norm", "step"}
    assert (float(m["loss"]).hex(), float(m["grad_norm"]).hex(),
            h.hexdigest()[:32]) == BEFORE[arch]


def test_device_counters_and_timers_on_the_cpu():
    """``count_on_device`` keeps a total on the tensor's device with no host
    read; ``timed`` times only CUDA work and hands back what it runs."""
    spans.count_on_device("moe.pairs", torch.tensor(3))
    spans.count_on_device("moe.pairs", torch.tensor(4))
    assert spans.device_total("moe.pairs") == 7
    assert spans.device_total("moe.dropped") == 0
    spans.time_device(True)
    try:
        x = torch.ones(3, requires_grad=True)
        out = spans.timed("moe", lambda t: (t * 2, t.sum()), x)
        assert torch.equal(out[0], torch.full((3,), 2.0))
        assert spans.device_ms("moe") == 0.0
    finally:
        spans.time_device(False)
    spans.reset()
    assert spans.device_total("moe.pairs") == 0


# -- the gathers' hand kernels ----------------------------------------------

GATHER_COUNTERS = ("moe.combine.fused", "moe.combine.plain",
                   "moe.gather.launches")


def _layer_calls(cfg, n_micro):
    """The combine's forwards (remat recomputes each) and backwards, and
    the dispatch's backwards, of a training step."""
    calls = cfg.num_layers * n_micro
    return calls * (2 if cfg.remat else 1), calls, calls


def test_cpu_step_takes_the_plain_gathers():
    cfg, model, _ = model_of(SMALL)
    tokens, labels = batch_of(SMALL["vocab_size"])
    program_step(cfg, model, tokens, labels, 2)
    forwards, backwards, _ = _layer_calls(cfg, 2)
    assert {c: spans.total(c) for c in GATHER_COUNTERS} == {
        "moe.combine.fused": 0, "moe.combine.plain": forwards + backwards,
        "moe.gather.launches": 0}


@pytest.mark.parametrize("K, held, d", [(3, 4, 8), (8, 16, 24), (10, 12, 5)])
def test_plain_gather_adds_in_k_order(K, held, d):
    """``gather_sum_plain``: each token's held pairs, scale times row,
    added to zero one at a time in k order (the kernel's order, past its
    groups of 8 too), the rows of pairs not held (here NaN) masked out, a
    row past R read at R - 1."""
    g = torch.Generator().manual_seed(K * 100 + d)
    T = 40
    top = torch.stack([torch.randperm(64, generator=g)[:K]
                       for _ in range(T)])
    row, valid, pair, _, _ = moe_mod.share_plan(top, 3, held)
    R = pair.shape[0]
    src = torch.randn(R, d, generator=g)
    src[int(valid.sum()):] = float("nan")
    scale = torch.rand(T, K, generator=g)
    row = torch.where(valid, row, R + 5)
    for sc in (scale, None):
        want = torch.zeros(T, d)
        for t in range(T):
            for k in range(K):
                if valid[t, k]:
                    x = src[min(int(row[t, k]), R - 1)]
                    want[t] = want[t] + (x if sc is None else sc[t, k] * x)
        assert torch.equal(moe_mod.gather_sum_plain(src, row, valid, sc),
                           want)


def _gather_args(**spoil):
    T, K, R, d = 4, 2, 6, 16
    args = dict(src=torch.zeros((R, d), dtype=torch.bfloat16),
                row=torch.zeros((T, K), dtype=torch.int64),
                valid=torch.zeros((T, K), dtype=torch.bool),
                scale=torch.ones((T, K)))
    args.update(spoil)
    return args


@pytest.mark.parametrize("spoil, match", [
    (dict(src=torch.zeros((6, 16), dtype=torch.float16)), "src"),
    (dict(row=torch.zeros((4, 2), dtype=torch.int32)), "row"),
    (dict(valid=torch.zeros((4, 2), dtype=torch.uint8)), "valid"),
    (dict(scale=torch.ones((4, 3))), "scale"),
    (dict(scale=torch.ones((4, 2), dtype=torch.bfloat16)), "scale"),
    (dict(src=torch.zeros((16, 6), dtype=torch.bfloat16).t()), "contiguous"),
    (dict(out_dtype=torch.float16), "out dtype"),
])
def test_gather_wrapper_refuses(monkeypatch, spoil, match):
    """What the kernels do not take raises a ValueError before anything is
    built (CPU tensors: ``test_torch_kernel_loader.py``)."""
    monkeypatch.setattr(kmg, "build_library", pytest.fail)
    with pytest.raises(ValueError, match=match):
        kmg.gather_sum(**_gather_args(**spoil))


def test_combine_backward_wrapper_refuses(monkeypatch):
    monkeypatch.setattr(kmg, "build_library", pytest.fail)
    a = _gather_args()
    for bad, match in ((torch.zeros((4, 16), dtype=torch.bfloat16), "gy"),
                       (torch.zeros((4, 8)), "gy")):
        with pytest.raises(ValueError, match=match):
            kmg.combine_backward(bad, a["src"], a["scale"], a["row"],
                                 a["valid"], torch.zeros(6, dtype=torch.int64))
    with pytest.raises(ValueError, match="pair"):
        kmg.combine_backward(torch.zeros((4, 16)), a["src"], a["scale"],
                             a["row"], a["valid"],
                             torch.zeros(5, dtype=torch.int64))


def test_gather_source_uses_no_atomics():
    """Every row and token is written by one block: no atomic operation,
    so a replay is bitwise the eager call."""
    code = [line.split("//")[0] for line in
            kmg.SOURCE.read_text().splitlines()]
    assert not any("atomic" in line.lower() for line in code)


def test_repair_planning_and_olmo_paths_leave_the_gathers_out():
    """In a fresh process: the package, the repair and planning modules,
    ``models`` and ``train``, and a CPU step of olmo-1b's and of the
    share's smoke configurations import no ``kernels.moe_gather``."""
    code = (
        "import sys, torch\n"
        "import repro_torch, repro_torch.kernels, repro_torch.kernels.ops\n"
        "import repro_torch.coding, repro_torch.storage.simulator\n"
        "import repro_torch.core, repro_torch.models, repro_torch.train\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import MoEShareConfig, Transformer\n"
        "from repro_torch.models import init_params, loss_terms\n"
        "toks = torch.zeros((2, 16), dtype=torch.int64)\n"
        "b = {'tokens': toks, 'labels': toks}\n"
        "cfg = get_smoke_config('olmo-1b')\n"
        "loss_terms(cfg, init_params(cfg, 0, device='cpu'), b)['loss']"
        ".backward()\n"
        f"share = MoEShareConfig(**{SMALL!r})\n"
        "loss_terms(share, Transformer(share, 'cpu'), b)['loss']"
        ".backward()\n"
        "print('repro_torch.kernels.moe_gather' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def _stand_ins(monkeypatch, spoil=None):
    """The kernels' calls replaced by the plain versions (each counting a
    launch; ``spoil(name, tensor)`` may change an output), and
    ``torch.cuda``'s graph and synchronize by stand-ins that run eagerly."""
    def gather_sum(src, row, valid, scale=None, out_dtype=torch.float32):
        spans.count("moe.gather.launches")
        out = moe_mod.gather_sum_plain(src, row, valid, scale).to(out_dtype)
        return spoil("y" if scale is not None else "gx", out) \
            if spoil else out

    def combine_backward(gy, src, gates, row, valid, pair):
        spans.count("moe.gather.launches")
        gye, gg = moe_mod.combine_backward_plain(gy, src, gates, row, valid,
                                                 pair)
        return (spoil("gye", gye), spoil("gg", gg)) if spoil else (gye, gg)

    class Graph:
        def replay(self):
            pass
    monkeypatch.setattr(kmg, "gather_sum", gather_sum)
    monkeypatch.setattr(kmg, "combine_backward", combine_backward)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: __import__(
        "contextlib").nullcontext())


def _one_off(target):
    """Change ``target``'s output at its first held element by one ulp."""
    def spoil(name, t):
        if name != target:
            return t
        t = t.clone()
        flat = t.view(-1)
        i = int(torch.nonzero(flat).view(-1)[0])
        flat.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32)[i] += 1
        return t
    return spoil


def _nan_leak(name, t):
    return t + float("nan") if name == "y" else t


@pytest.mark.parametrize("spoil", [None, "y", "gx", "gye", "nan"])
def test_gather_gate_on_the_cpu(monkeypatch, spoil):
    """``moe_gather_against_plain`` at a small share, with the plain
    versions standing in for the kernels: the sound stand-ins pass; one
    a bit off in y, gx or gye, or a NaN leaked from a masked row, fails."""
    _stand_ins(monkeypatch, None if spoil is None else
               _nan_leak if spoil == "nan" else _one_off(spoil))
    ops = gates.moe_gather_operands(64, 4, 16, 16, 2, 4, seed=5,
                                    device="cpu", skew=0.5)
    assert ops["held"] > 0 and ops["dropped"] == 0
    if spoil is None:
        rec = gates.moe_gather_against_plain(ops, "stand-in")
        assert rec["launches"] == rec["captured_launches"] == 3
        assert rec["gg_gaps"]["plain"] == 0.0
        assert rec["gg_gaps"]["fused_exact"] < 1e-6
    else:
        with pytest.raises(AssertionError, match="against the plain"):
            gates.moe_gather_against_plain(ops, "stand-in")


def test_gather_gate_refuses_gg_past_its_tolerance(monkeypatch):
    def spoil(name, t):
        return t * (1 + 2 * gates.GATHER_GG_RTOL) if name == "gg" else t
    _stand_ins(monkeypatch, spoil)
    ops = gates.moe_gather_operands(32, 3, 8, 8, 0, 4, seed=2, device="cpu")
    with pytest.raises(AssertionError, match="gg within"):
        gates.moe_gather_against_plain(ops, "stand-in")


def test_gather_operands_with_the_capacity_plan():
    """The skewed router over the capacity plan drops pairs, as the chip
    gate's case asks; the rows past the held pairs' are NaN."""
    def plan(top, first, held):
        return capacity_plan(top, first, held, 16)
    ops = gates.moe_gather_operands(256, 4, 8, 16, 0, 4, seed=1,
                                    device="cpu", skew=3.0, plan=plan)
    assert ops["dropped"] > 0 and ops["held"] == int(ops["valid"].sum())
    assert torch.isnan(ops["ye"][ops["held"]:]).all()
    assert not torch.isnan(ops["ye"][:ops["held"]]).any()


# -- the gathers on the card ----------------------------------------------

OLMOE_MB = dict(T=8192, K=8, d=2048, experts=64, first=0, held=16)
GATHER_CASES = [
    # label, shapes, router skew, capacity plan, rows' dtype
    ("olmoe-benchmark-router", OLMOE_MB, 0.0, False, torch.bfloat16),
    ("olmoe-skewed-router", OLMOE_MB, 2.0, False, torch.bfloat16),
    ("olmoe-skewed-capacity", OLMOE_MB, 2.0, True, torch.bfloat16),
    ("olmoe-benchmark-capacity", OLMOE_MB, 0.0, True, torch.bfloat16),
    ("odd-fp32", dict(T=301, K=10, d=203, experts=40, first=5, held=12),
     1.0, False, torch.float32),
    ("odd-bf16", dict(T=77, K=3, d=36, experts=8, first=2, held=4), 0.0,
     False, torch.bfloat16),
]


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("label, shape, skew, capacity, dtype", GATHER_CASES,
                         ids=[c[0] for c in GATHER_CASES])
def test_gather_kernels_against_plain(card, label, shape, skew, capacity,
                                      dtype):
    shape = dict(shape)
    experts = shape.pop("experts")

    def plan(top, first, held):
        return capacity_plan(top, first, held, experts)
    ops = gates.moe_gather_operands(
        **shape, experts=experts, seed=11, device=torch.device("cuda", 0),
        skew=skew, plan=plan if capacity else None, dtype=dtype)
    if not capacity:
        assert ops["dropped"] == 0
    elif skew > 0:
        assert ops["dropped"] > 0
    rec = gates.moe_gather_against_plain(ops, label)
    assert rec["bitwise"] == {"y": True, "gx": True, "gye": True}


def _bf16_share():
    mdl = dict(SMALL, param_dtype="bfloat16", compute_dtype="bfloat16",
               num_experts=4, expert_offset=2, experts_per_token=3)
    cfg = MoEShareConfig(**mdl)
    model = Transformer(cfg, "cuda")
    w = gen_moe.moe_weights(mdl, 3, "cuda", torch.bfloat16)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return cfg, model


@pytest.mark.chip
def test_cuda_step_takes_the_gathers(card):
    """An eager CUDA step of the share in bf16: every combine on the
    kernels, none plain, one launch a call."""
    cfg, model = _bf16_share()
    oc = OptimizerConfig()
    step = EagerTrainStep(cfg, oc, model, init_opt(oc, model, device="cuda"),
                          n_micro=2)
    tokens, labels = batch_of(cfg.vocab_size)
    metrics = step({"tokens": tokens.cuda(), "labels": labels.cuda()})
    assert torch.isfinite(metrics["loss"])
    forwards, backwards, dispatch = _layer_calls(cfg, 2)
    assert {c: spans.total(c) for c in GATHER_COUNTERS} == {
        "moe.combine.fused": forwards + backwards, "moe.combine.plain": 0,
        "moe.gather.launches": forwards + backwards + dispatch}


@pytest.mark.chip
def test_share_graph_is_bitwise_the_eager_step(card):
    """A ``TrainGraph`` of the share (eager, capture, replay) against the
    eager step from the same weights over the same 3 batches: losses, grad
    norms and every parameter bitwise."""
    runs = []
    for kind in (EagerTrainStep, TrainGraph):
        cfg, model = _bf16_share()
        oc = OptimizerConfig()
        step = kind(cfg, oc, model, init_opt(oc, model, device="cuda"),
                    n_micro=2)
        out = []
        for seed in range(3):
            tokens, labels = batch_of(cfg.vocab_size, seed=seed)
            m = step({"tokens": tokens.cuda(), "labels": labels.cuda()})
            out.append((m["loss"].clone(), m["grad_norm"].clone()))
        runs.append((out, {n: p.detach().clone()
                           for n, p in model.named_parameters()}))
    (eager, pe), (graph, pg) = runs
    for (a, b), (c, d) in zip(eager, graph):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert all(torch.equal(pe[n], pg[n]) for n in pe)
