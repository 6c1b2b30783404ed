"""The fused attention kernel (``repro_torch.kernels.attention``) and its
route (``models.layers.attention``).

On the CPU: the rule that engages the kernel (``fused_attention_engages``:
devices, dtypes, head dims, a cache, shared positions), which full configs
take it, and that the CPU route is ``chunked_attention``'s, bitwise, with
the counter ``attn.fused`` left at 0.

On the card (marked ``chip``, skipped without one; this file imports JAX
only inside the CPU tests that run the reference): the kernel's output
and its dQ, dK and dV against ``chunked_attention``'s on the card, at
olmo-1b's training shape (2 x 2,048 x 16 heads x 128, causal), yi-6b's
GQA (32 query heads over 4 KV heads, 128), one non-causal shape, and a
ragged head-dim-64 sequence at shuffled positions; and against the
reference package's ``chunked_attention`` (JAX) at three small shapes,
through its readings recorded in ``tests/data/attention_reference.npz``
(which the CPU tests hold to the reference, bitwise, and the port's plain
version to, by the same gates).  Each side and an fp64 dense attention
see the same bf16 q, k, v and upstream gradient.  Tolerances:

* each output within ``ULPS`` = 3 bf16 ulps (of its largest magnitude)
  of the compared version's (the port's plain version on the card, or
  the reference's recording), element by element: each side's worst
  element lies up to about 1.3 ulp from the fp64 value (1.32 the
  kernel's dQ, 1.09 the plain version's dK at olmo-1b's shape, NVIDIA
  H100), so two sound results differ by up to their sum (2.0 seen).  The
  kernel's dQ has its worst element in the first rows of a causal
  sequence: the plain version's graph also sends the row's sum of dS
  through its max to the argmax score, a term that is zero but for
  rounding and cancels dP's rounding to bf16 in a row of few keys; the
  kernel leaves it out, as FlashAttention does;
* the kernel's relative RMS error against the fp64 attention at most
  ``RATIO`` = 1.1 times the compared version's: the same precision (0.74
  to 1.00 times the plain version's seen; the kernel rounds dQ, dK and
  dV once, where the plain version also rounds each query chunk's dK and
  dV to bf16 and sums them in bf16).  The sound errors are about 2e-3,
  bf16's rounding of the outputs; one wrong row of 2,048 alone reads
  about 2e-2, ten times that.
"""
import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels.attention import HEAD_DIMS, fused_attention_engages
from repro_torch.models import init_params, layers
from repro_torch.models.transformer import loss_fn
from repro_torch.obs import spans

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)
BF, F32 = torch.bfloat16, torch.float32
ULPS, RATIO = 3.0, 1.1
NAMES = ("out", "dq", "dk", "dv")

# (label, B, S, H, KV, D, causal, shuffled positions)
CARD_CASES = [("olmo-1b", 2, 2048, 16, 16, 128, True, False),
              ("yi-6b-gqa", 1, 2048, 32, 4, 128, True, False),
              ("full", 2, 512, 8, 8, 128, False, False),
              ("ragged-d64", 1, 1000, 16, 16, 64, True, True)]


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


def engages(device=CUDA, dtypes=(BF, BF, BF), head_dim=128, seq=2048,
            cached=False, self_attention=True):
    return fused_attention_engages(device, dtypes, head_dim, seq,
                                   cached=cached,
                                   self_attention=self_attention)


# -- the rule, on the CPU ------------------------------------------------------

@pytest.mark.parametrize("case, want", [
    (dict(), True),
    (dict(head_dim=64), True),
    (dict(seq=1), True),
    (dict(seq=1000), True),                    # the kernel masks the edge
    (dict(seq=kattn.MAX_SEQ), True),
    (dict(seq=kattn.MAX_SEQ + 1), False),
    (dict(device=CPU), False),
    (dict(device=torch.device("meta")), False),
    (dict(dtypes=(F32, F32, F32)), False),
    (dict(dtypes=(BF, BF, F32)), False),
    (dict(dtypes=(torch.float16,) * 3), False),
    (dict(head_dim=8), False),
    (dict(head_dim=80), False),
    (dict(head_dim=112), False),
    (dict(head_dim=160), False),
    (dict(cached=True), False),
    (dict(self_attention=False), False),
])
def test_rule(case, want):
    assert engages(**case) is want


# which full configs take the kernel in training and prefill on the card
ENGAGED = {"olmo-1b", "olmoe-1b-7b", "yi-6b", "qwen2.5-14b", "qwen1.5-0.5b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_route(arch):
    cfg = get_config(arch)
    c = layers.dt(cfg)
    takes = cfg.family != "ssm" and engages(
        dtypes=(c, c, c), head_dim=cfg.head_dim, seq=2048)
    assert takes is (arch in ENGAGED)
    # a decode step over a cache never does, nor the CPU
    assert not engages(dtypes=(c, c, c), head_dim=cfg.head_dim, cached=True)
    assert not engages(device=CPU, dtypes=(c, c, c), head_dim=cfg.head_dim)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_configs_keep_chunked(arch):
    """The CPU-sized configs' head dims are outside the kernel's, so a
    smoke config on the card would not change path either."""
    cfg = get_smoke_config(arch)
    assert cfg.head_dim not in HEAD_DIMS
    assert not engages(head_dim=cfg.head_dim)


def _qkv(gen, B, S, H, KV, D, dtype, device="cpu"):
    def draw(heads):
        return torch.randn((B, S, heads, D), generator=gen,
                           dtype=F32).to(device=device, dtype=dtype)
    return draw(H), draw(KV), draw(KV)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_route_is_chunked(dtype, causal):
    gen = torch.Generator().manual_seed(7)
    q, k, v = _qkv(gen, 2, 24, 4, 2, 16, dtype)
    pos = torch.arange(24, dtype=torch.int32)
    kw = dict(causal=causal, q_positions=pos, kv_positions=pos, q_chunk=8,
              kv_chunk=16)
    got = layers.attention(q, k, v, cached=False, **kw)
    want = layers.chunked_attention(q, k, v, **kw)
    assert torch.equal(got, want)
    assert spans.total("attn.chunked") == 1
    assert spans.total("attn.fused") == 0


def test_cpu_model_counts():
    """A training loss and its gradient on the CPU: every attention call
    takes the chunked route, none the kernel, none of its launches."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), remat=True)
    model = init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss_fn(cfg, model, {"tokens": toks, "labels": toks}).backward()
    # one call a layer, and one more for each layer's recompute
    assert spans.total("attn.chunked") == 2 * cfg.num_layers
    for name in ("attn.fused", "attn.launches.forward",
                 "attn.launches.backward"):
        assert spans.total(name) == 0


@pytest.mark.parametrize("head_dim, causal", [(128, True), (64, False)])
def test_build_parts(monkeypatch, head_dim, causal):
    """One variant (head dim, causal flag) is one library of the one
    source, for sm_90a, with the forward and the backward in it."""
    seen = []
    monkeypatch.setattr(kattn, "build_library",
                        lambda *job: seen.append(job) or (None, ""))
    kattn.build(head_dim, causal)
    [(src, stem, flags, build_dir)] = seen
    assert src == kattn.SOURCE and build_dir == kattn.BUILD_DIR
    assert stem == f"libattention_d{head_dim}_" \
        f"{'causal' if causal else 'full'}"
    assert "arch=compute_90a,code=sm_90a" in flags
    assert {f"-DATTN_HEAD_DIM={head_dim}",
            f"-DATTN_CAUSAL={int(causal)}"} <= set(flags)


def test_fused_attention_refuses_cpu():
    gen = torch.Generator().manual_seed(3)
    q, k, v = _qkv(gen, 1, 64, 2, 2, 64, BF)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.fused_attention(q, k, v, torch.arange(64), causal=True)


# -- the kernel against the plain version, on the card ------------------------

def _dense64(q, k, v, pos, causal):
    """fp64 attention of fp64 operands (GQA by repeating KV heads)."""
    G = q.shape[2] // k.shape[2]
    kd = k.repeat_interleave(G, dim=2)
    vd = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kd) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)


def _hold(got, want, exact):
    """Each of ``got``'s out, dQ, dK, dV (bf16) within ``ULPS`` bf16 ulps of
    the largest magnitude of ``want``'s, element by element, and its
    relative RMS error against ``exact``'s (fp64) at most ``RATIO`` times
    ``want``'s."""
    for name, a, b, x in zip(NAMES, got, want, exact):
        a, b, x = (t.to(x.device) for t in (a, b, x))
        assert a.dtype == BF and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        top = float(b.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        gap = float((a.float() - b.float()).abs().max())
        assert gap <= ULPS * ulp, (name, gap / ulp)
        rms_a = float((a.double() - x).norm() / x.norm())
        rms_b = float((b.double() - x).norm() / x.norm())
        assert rms_a <= RATIO * rms_b, (name, rms_a, rms_b)


def _run(fn, q, k, v, g):
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(qs, ks, vs)
    out.backward(g)
    return [out.detach(), qs.grad, ks.grad, vs.grad]


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_chunked(card, case):
    _, B, S, H, KV, D, causal, shuffled = case
    gen = torch.Generator().manual_seed(sum(case[1:6]))
    q, k, v = (t.to(CUDA) for t in _qkv(gen, B, S, H, KV, D, BF))
    g = torch.randn((B, S, H, D), generator=gen).to(CUDA, BF)
    pos = (torch.randperm(S, generator=gen) if shuffled
           else torch.arange(S)).to(CUDA, torch.int32)
    chunk = dict(causal=causal, q_positions=pos, kv_positions=pos,
                 q_chunk=1024, kv_chunk=2048)
    fused = _run(lambda a, b, c: kattn.fused_attention(a, b, c, pos,
                                                       causal=causal),
                 q, k, v, g)
    plain = _run(lambda a, b, c: layers.chunked_attention(a, b, c, **chunk),
                 q, k, v, g)
    exact = _run(lambda a, b, c: _dense64(a, b, c, pos.long(), causal),
                 q.double(), k.double(), v.double(), g.double())
    torch.cuda.synchronize()
    assert spans.total("attn.launches.forward") == 1
    assert spans.total("attn.launches.backward") == 1
    _hold(fused, plain, exact)


# -- the kernel against the reference package, through a recorded reading ----
#
# The reference's ``chunked_attention`` (JAX) runs only on the CPU, and the
# kernel only on the card, so the reference's output and gradients at three
# small shapes are recorded in ``REFERENCE`` from inputs that numpy's PCG64
# draws the same on any host.  On the CPU, the recording is held to the
# reference run again and the port's plain version to the recording; on the
# card, the kernel to the recording by ``_hold``'s two gates.

# (label, B, S, H, KV, D, causal, shuffled positions)
REF_CASES = [("causal-d128", 1, 256, 2, 2, 128, True, False),
             ("gqa-d64-ragged", 1, 200, 4, 1, 64, True, True),
             ("full-d128", 1, 128, 2, 2, 128, False, False)]
REFERENCE = pathlib.Path(__file__).resolve().parent / "data" \
    / "attention_reference.npz"


def _ref_inputs(case):
    """q, k, v and the upstream gradient (bf16, on the CPU) and the
    positions (int32) of a ``REF_CASES`` case."""
    _, B, S, H, KV, D, _, shuffled = case
    rng = np.random.default_rng(sum(case[1:6]))

    def draw(heads):
        return torch.from_numpy(rng.standard_normal(
            (B, S, heads, D), dtype=np.float32)).to(BF)

    q, k, v, g = draw(H), draw(KV), draw(KV), draw(H)
    pos = rng.permutation(S) if shuffled else np.arange(S)
    return q, k, v, g, torch.from_numpy(pos.astype(np.int32))


def _jax_reference(case):
    """The reference's ``chunked_attention`` and its gradient by
    ``jax.vjp`` at a case's inputs (on the CPU): out, dq, dk, dv as int16
    words of their bf16 values.  Skipped on a host with a CUDA card, where
    JAX would take the card: the reference runs on CPU hosts only."""
    if torch.cuda.is_available():
        pytest.skip("the reference runs on CPU hosts only")
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.models.layers import chunked_attention as reference

    q, k, v, g, pos = _ref_inputs(case)
    p = jnp.asarray(pos.numpy())

    def arr(t):
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)

    out, vjp = jax.vjp(lambda a, b, c: reference(
        a, b, c, causal=case[6], q_positions=p, kv_positions=p,
        q_chunk=1024, kv_chunk=2048), arr(q), arr(k), arr(v))
    return {name: np.asarray(x.view(jnp.int16))
            for name, x in zip(NAMES, (out, *vjp(arr(g))))}


def _recorded(case):
    with np.load(REFERENCE) as data:
        return [torch.from_numpy(data[f"{case[0]}/{name}"]).view(BF)
                for name in NAMES]


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_recorded_reference_is_the_references(case):
    want = _jax_reference(case)
    for name, got in zip(NAMES, _recorded(case)):
        assert np.array_equal(got.view(torch.int16).numpy(), want[name]), name


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_cpu_chunked_matches_recorded_reference(case):
    """The port's plain version on the CPU (its products in fp32) against
    the reference's recording, by the card cases' gates."""
    q, k, v, g, pos = _ref_inputs(case)
    causal = case[6]
    plain = _run(lambda a, b, c: layers.chunked_attention(
        a, b, c, causal=causal, q_positions=pos, kv_positions=pos,
        q_chunk=1024, kv_chunk=2048), q, k, v, g)
    exact = _run(lambda a, b, c: _dense64(a, b, c, pos.long(), causal),
                 q.double(), k.double(), v.double(), g.double())
    _hold(plain, _recorded(case), exact)


@pytest.mark.chip
@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_kernel_matches_recorded_reference(card, case):
    q, k, v, g, pos = (t.to(CUDA) for t in _ref_inputs(case))
    causal = case[6]
    fused = _run(lambda a, b, c: kattn.fused_attention(a, b, c, pos,
                                                       causal=causal),
                 q, k, v, g)
    exact = _run(lambda a, b, c: _dense64(a, b, c, pos.long(), causal),
                 q.double(), k.double(), v.double(), g.double())
    _hold(fused, _recorded(case), exact)


def write_reference(path=REFERENCE):
    """Record the reference's readings of ``REF_CASES`` at ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{
        f"{case[0]}/{name}": words for case in REF_CASES
        for name, words in _jax_reference(case).items()})


if __name__ == "__main__":      # PYTHONPATH=src python tests/test_torch_attention.py
    write_reference()
    sys.exit(0)
