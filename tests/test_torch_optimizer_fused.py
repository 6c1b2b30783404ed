"""The fused AdamW (``repro_torch.kernels.adamw``) and its route
(``train.optimizer``).

On the CPU: the kernel's library stays off the repair and planning paths'
imports (checked in fresh processes) and importing ``repro_torch.train``
builds nothing; the library's build arguments; the chunk map, a pure
function, covers every element of every tensor once at olmo-1b's and
OLMoE's parameter lists and fits Hopper's kernel parameters; the wrapper
refuses what the kernel does not take; a CPU step takes the plain route
(counters ``optim.plain``, ``optim.fused``, ``optim.launches``); and
handing the optimizer the accumulators with ``n_micro`` leaves the plain
route's result bitwise what dividing them first gave.

On the card (marked ``chip``, skipped without one): the kernel against
the plain version at mixed dtypes, unaligned tensors, more tensors than
one launch holds and the leaves of olmo-1b (1.28 B parameters) and of
OLMoE's share in the benchmark (1.147 B), by the gates of
``repro_torch.kernels.gates.adamw_against_plain`` (which ``chip_smoke.py``
calls too): against the plain update run at the kernel's clip, m and v
within 2 fp32 ulps and each parameter within 1 ulp of its dtype; the norm
within 1e-5 relative of the plain version's (fp32 sums) and 1e-6 of an
fp64 norm; and a captured replay bitwise the eager call.
"""
import bisect
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import gates
from repro_torch.kernels import nvcc
from repro_torch.models import (ModelConfig, MoEShareConfig, Transformer,
                                init_params)
from repro_torch.obs import spans
from repro_torch.train import (EagerTrainStep, OptimizerConfig, init_opt,
                               optimizer)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ADAMW = "repro_torch.kernels.adamw"
BF, F32 = torch.bfloat16, torch.float32
COUNTERS = ("optim.fused", "optim.plain", "optim.launches")


@pytest.fixture(autouse=True)
def clean_counters():
    """One torch thread beside the suite's other workers, and counters
    that start at zero."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")))


# -- the build stays off the repair and planning paths ----------------------

@pytest.mark.parametrize("module", [
    "repro_torch.kernels.ops", "repro_torch.coding",
    "repro_torch.storage.simulator", "repro_torch.core"])
def test_repair_and_planning_imports_leave_adamw_out(module):
    """The modules the repair loop (``kernels.ops``, ``coding``,
    ``storage.simulator``) and the planning loop (``core``) import do not
    load the fused AdamW, in a fresh process."""
    out = _python(f"import sys, {module}\n"
                  f"print({ADAMW!r} in sys.modules)")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def test_importing_train_builds_nothing():
    """``repro_torch.train`` imports the wrapper, and importing it calls no
    ``build_library``: every binding of it raises, in a fresh process."""
    out = _python(
        "import sys\n"
        "import repro_torch.kernels.nvcc as nvcc\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('build_library called')\n"
        "nvcc.build_library = boom\n"
        "for name in ('repro_torch.kernels.attention',\n"
        "             'repro_torch.kernels.gf_matmul'):\n"
        "    sys.modules[name].build_library = boom\n"
        "import repro_torch.train\n"
        f"print({ADAMW!r} in sys.modules,\n"
        f"      sys.modules[{ADAMW!r}].build_library is boom)")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True"]


def test_build_parts(monkeypatch):
    """One library of the one source, for sm_90a, with the shared flags as
    they are (so ``gf_matmul`` and ``attention`` keep their hashes)."""
    seen = []
    monkeypatch.setattr(kadamw, "build_library",
                        lambda *job: seen.append(job) or (None, ""))
    kadamw.build()
    [(src, stem, flags, build_dir)] = seen
    assert src == kadamw.SOURCE and src.name == "adamw.cu"
    assert build_dir == nvcc.BUILD_DIR
    assert stem == "libadamw"
    assert flags == nvcc.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert "--use_fast_math" not in flags


# -- the chunk map ------------------------------------------------------------

def _tensor_of(first_chunk, count, c):
    """The source's ``tensor_of``, line for line."""
    lo, hi = 0, count - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first_chunk[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _covers_once(numels, groups, chunk):
    """Walk every chunk of every launch as the kernel does and check that
    the elements of each tensor are covered once, in order."""
    covered = [0] * len(numels)
    assert [g.lo for g in groups] == \
        list(range(0, len(numels), kadamw.MAX_TENSORS))[:len(groups)]
    assert groups[-1].hi == len(numels)
    for g in groups:
        count = g.hi - g.lo
        assert 1 <= count <= kadamw.MAX_TENSORS
        assert len(g.first_chunk) == count + 1 and g.first_chunk[0] == 0
        for c in range(g.first_chunk[-1]):
            i = _tensor_of(g.first_chunk, count, c)
            assert i == bisect.bisect_right(g.first_chunk, c) - 1
            lo = (c - g.first_chunk[i]) * chunk
            hi = min(lo + chunk, numels[g.lo + i])
            assert lo == covered[g.lo + i] and hi > lo
            covered[g.lo + i] = hi
    assert covered == list(numels)


def _model(kind):
    if kind == "olmo-1b":
        return get_config("olmo-1b")
    conf = json.loads((ROOT / "perfbench" / "configs" / kind).read_text())
    make = MoEShareConfig if "num_experts" in conf["model"] and \
        conf["model"].get("family") == "moe" else ModelConfig
    return make(**conf["model"])


@pytest.mark.parametrize("kind", ["olmo-1b", "olmo-1b-ec8.json",
                                  "olmoe-1b-7b-ec8.json"])
def test_chunk_map_covers_the_train_configurations(kind):
    """At the train cells' parameter lists (and olmo-1b's untied one):
    every element of every tensor in exactly one chunk, one launch of each
    kind, the kernel's parameters within Hopper's limit."""
    cfg = _model(kind)
    numels = [p.numel() for p in
              Transformer(cfg, "meta", allow_meta=True).parameters()]
    assert sum(numels) == cfg.param_count()
    groups = kadamw.chunk_map(numels)
    assert len(groups) == 1
    _covers_once(numels, groups, kadamw.CHUNK)
    assert kadamw.TENSORS_BYTES + kadamw.OTHER_PARAM_BYTES \
        <= kadamw.PARAM_LIMIT


@pytest.mark.parametrize("numels, chunk", [
    ([1, 0, 7, 8, 9, 0], 4),
    ([0, 5], 8),
    ([3] * 600 + [0, 17], 2),        # three launches of each kind
    ([kadamw.CHUNK * 3 + 1, 2, kadamw.CHUNK], kadamw.CHUNK),
])
def test_chunk_map_ragged_and_empty_tensors(numels, chunk):
    groups = kadamw.chunk_map(numels, chunk=chunk)
    assert len(groups) == -(-len(numels) // kadamw.MAX_TENSORS)
    _covers_once(numels, groups, chunk)


def test_chunk_map_refuses_too_many_chunks():
    with pytest.raises(ValueError, match="chunks"):
        kadamw.chunk_map([2 ** 31], chunk=1)


# -- the wrapper's checks -----------------------------------------------------

def _operands(n=3, p=BF, g=F32, mom=F32, device="cpu"):
    shapes = [(4, 8), (16,), (3, 5, 2)][:n]
    return ([torch.zeros(s, dtype=p, device=device) for s in shapes],
            [torch.zeros(s, dtype=g, device=device) for s in shapes],
            [torch.zeros(s, dtype=mom, device=device) for s in shapes],
            [torch.zeros(s, dtype=mom, device=device) for s in shapes],
            torch.zeros((), dtype=torch.int32, device=device))


def _call(params, grads, m, v, step):
    return kadamw.FusedAdamW()(params, grads, m, v, step, 1e-3, b1=0.9,
                               b2=0.95, eps=1e-8, weight_decay=0.1,
                               grad_clip=1.0)


@pytest.mark.parametrize("spoil, match", [
    (lambda ops: ops[0].__setitem__(1, ops[0][1].half()), "dtypes"),
    (lambda ops: ops[1].__setitem__(0, ops[1][0].double()), "dtypes"),
    (lambda ops: ops[3].__setitem__(2, ops[3][2].bfloat16()), "dtypes"),
    (lambda ops: ops[1].__setitem__(0, ops[1][0].t().contiguous().t()),
     "contiguous"),
    (lambda ops: ops[2].__setitem__(2, ops[2][2].transpose(0, 2)),
     "shapes"),
    (lambda ops: ops[3].pop(), "moments"),
])
def test_wrapper_refuses(monkeypatch, spoil, match):
    """fp16 or fp64 operands, m and v of two dtypes, a non-contiguous or
    misshapen tensor, lists of unequal lengths: a ValueError before
    anything is built (CPU tensors: ``test_torch_kernel_loader.py``)."""
    monkeypatch.setattr(kadamw, "build_library", pytest.fail)
    ops = list(_operands())
    spoil(ops)
    with pytest.raises(ValueError, match=match):
        _call(*ops)


def test_kind_bits():
    p, g, m, _, _ = _operands(1)
    assert kadamw.kind(p[0], g[0], m[0]) == kadamw.P_BF16
    assert kadamw.kind(p[0].float(), g[0].bfloat16(), m[0].bfloat16()) == \
        kadamw.G_BF16 | kadamw.M_BF16


# -- the route on the CPU -----------------------------------------------------

@pytest.mark.parametrize("mode", ["adamw", "adafactor"])
def test_cpu_step_takes_the_plain_route(mode):
    cfg = get_smoke_config("olmo-1b")
    model = init_params(cfg, 0, device="cpu")
    opt_cfg = OptimizerConfig(mode=mode)
    step = EagerTrainStep(cfg, opt_cfg, model,
                          init_opt(opt_cfg, model, device="cpu"), n_micro=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    step({"tokens": toks, "labels": toks})
    assert {c: spans.total(c) for c in COUNTERS} == \
        {"optim.fused": 0, "optim.plain": 1, "optim.launches": 0}
    assert not optimizer.fused_route(opt_cfg, optimizer.named_params(model))


def test_route_rule():
    """The dry run's meta tensors and the CPU's take the plain route."""
    for dev in ("meta", "cpu"):
        assert not optimizer.fused_route(
            OptimizerConfig(), {"w": torch.empty(1, device=dev)})


def _state(gdt, seed):
    gen = torch.Generator().manual_seed(seed)
    shapes = {"a": (8, 16), "b": (33,), "c": (2, 3, 5)}
    params = {n: (torch.randn(s, generator=gen) * 0.02).to(BF)
              for n, s in shapes.items()}
    acc = {n: (torch.randn(s, generator=gen) * 0.3).to(gdt)
           for n, s in shapes.items()}
    state = init_opt(OptimizerConfig(), params, device="cpu")
    for n in shapes:
        state.m[n].copy_(torch.randn(shapes[n], generator=gen) * 1e-2)
        state.v[n].copy_(torch.randn(shapes[n], generator=gen) ** 2 * 1e-4)
    state.step.fill_(4)
    return params, acc, state


@pytest.mark.parametrize("gdt", [F32, BF])
@pytest.mark.parametrize("n_micro", [1, 2, 3])
def test_n_micro_leaves_the_plain_route_bitwise(gdt, n_micro):
    """The accumulators as ``GradSums`` over ``n_micro`` give the plain
    route's result of the gradients divided first (the step's former
    ``a.float().div_``), bit for bit: parameters, moments, step and
    norm."""
    cfg = OptimizerConfig()
    p1, acc1, s1 = _state(gdt, 7)
    _, st1, norm1 = optimizer._apply_updates(
        cfg, p1, {n: a.float().div_(n_micro) for n, a in acc1.items()}, s1)
    p2, acc2, s2 = _state(gdt, 7)
    _, st2, norm2 = optimizer._apply_updates(
        cfg, p2, optimizer.GradSums(acc2, n_micro), s2)
    assert torch.equal(norm1, norm2) and torch.equal(st1.step, st2.step)
    for n in p1:
        for a, b in ((p1[n], p2[n]), (s1.m[n], s2.m[n]),
                     (s1.v[n], s2.v[n])):
            assert torch.equal(a, b)
    assert spans.total("optim.plain") == 2


# -- the kernel on the card ---------------------------------------------------

CARD_CASES = [
    # label, shapes (or a train configuration, whose leaves' shapes and
    # dtypes are drawn on the card), parameter dtypes, moment dtype,
    # gradient dtype, offset
    ("olmoe-like", [(2048, 64), (50304, 64), (64,), (16, 2048, 128)],
     [BF, BF, F32, BF], F32, F32, 0),
    ("bf16-moments-and-grads", [(1000, 33), (7,), (65537,)],
     [BF, F32, BF], BF, BF, 0),
    ("unaligned", [(999, 31), (5,), (70001,)], [BF, BF, F32], F32, F32, 3),
    ("three-launches", [(257,)] * 300 + [(3, 3)] * 300, [BF] * 600, F32,
     F32, 0),
    ("olmo-1b-leaves", "olmo-1b", None, F32, F32, 0),      # 1.28 B
    ("olmoe-share-leaves", "olmoe-1b-7b-ec8.json", None, F32, F32, 0),
]


@pytest.mark.chip
@pytest.mark.parametrize("label, shapes, dtypes, mdt, gdt, offset",
                         CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_kernel_against_plain(card, label, shapes, dtypes, mdt, gdt, offset,
                              n_micro):
    dev = torch.device("cuda", 0)
    on = "cpu"
    if isinstance(shapes, str):
        shapes, dtypes = zip(*[(p.shape, p.dtype) for p in Transformer(
            _model(shapes), "meta", allow_meta=True).parameters()])
        on = dev
    draw = dict(shapes=shapes, dtypes=dtypes, mdt=mdt, gdt=gdt, seed=3,
                device=dev, offset=offset, on=on)
    gates.adamw_against_plain(draw, OptimizerConfig(), n_micro, label)


@pytest.mark.chip
def test_cuda_step_takes_the_kernel(card):
    """An eager CUDA step at olmo-1b's smoke configuration in bf16: one
    fused call, two launches, no plain one."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_params(cfg, 0, device="cuda")
    opt_cfg = OptimizerConfig()
    step = EagerTrainStep(cfg, opt_cfg, model,
                          init_opt(opt_cfg, model, device="cuda"), n_micro=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    metrics = step({"tokens": toks, "labels": toks})
    assert torch.isfinite(metrics["grad_norm"])
    assert {c: spans.total(c) for c in COUNTERS} == \
        {"optim.fused": 1, "optim.plain": 0, "optim.launches": 2}
