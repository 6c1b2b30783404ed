"""The fused attention kernel (``repro_torch.kernels.attention``) and its
route (``models.layers.attention``).

On the CPU: the rule that engages the kernel (``fused_attention_engages``:
devices, dtypes, head dims, a cache, shared positions), which full configs
take it, and that the CPU route is ``chunked_attention``'s, bitwise, with
the counter ``attn.fused`` left at 0; and the exactness of the split that
the backward's products rest on (a TF32 value as two bf16 halves).

On the card (marked ``chip``, skipped without one; this file imports JAX
only inside the CPU tests that run the reference): the kernel's output
and its dQ, dK and dV against ``chunked_attention``'s on the card, at
olmo-1b's training shape (2 x 2,048 x 16 heads x 128, causal), OLMoE's
(2 x 4,096 x 16 x 128, causal) on q and k through its QK-norm (a weighted
RMSNorm over all heads' features, eps 1e-5, scales 1 + 0.1 N(0, 1)) and
RoPE (theta 10,000), yi-6b's GQA (32 query heads over 4 KV heads, 128),
one non-causal shape, a ragged head-dim-64 sequence at shuffled
positions, and the backward's cases in every variant (ragged lengths, GQA
of four, causal and full), each also repeated bitwise; and against the
reference package's ``chunked_attention`` (JAX) at three small shapes,
through its readings recorded in ``tests/data/attention_reference.npz``
(which the CPU tests hold to the reference, bitwise, and the port's plain
version to, by the same gates).  Each side and an fp64 dense attention
see the same bf16 q, k, v and upstream gradient.  The gates and their
tolerances (3 bf16 ulps of each output's largest magnitude; a relative
RMS error against the fp64 attention at most 1.1 times the compared
version's) live in ``repro_torch.kernels.gates``, which ``chip_smoke.py``
calls too.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import gates
from repro_torch.kernels.attention import HEAD_DIMS, fused_attention_engages
from repro_torch.models import init_params, layers
from repro_torch.models.transformer import loss_fn
from repro_torch.obs import spans

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)
BF, F32 = torch.bfloat16, torch.float32
NAMES = gates.ATTN_NAMES

# (label, B, S, H, KV, D, causal, shuffled positions, QK-norm)
CARD_CASES = [("olmo-1b", 2, 2048, 16, 16, 128, True, False, False),
              ("yi-6b-gqa", 1, 2048, 32, 4, 128, True, False, False),
              ("full", 2, 512, 8, 8, 128, False, False, False),
              ("ragged-d64", 1, 1000, 16, 16, 64, True, True, False),
              ("olmoe-qk-norm", 2, 4096, 16, 16, 128, True, False, True)]


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
            cached=False, self_attention=True, v_dim=None):
    return fused_attention_engages(device, dtypes, head_dim, seq,
                                   cached=cached,
                                   self_attention=self_attention, v_dim=v_dim)


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
    # multi-head latent attention's variant: q and k at 192, v at 128
    (dict(head_dim=192, v_dim=128), True),
    (dict(head_dim=192), False),
    (dict(head_dim=192, v_dim=192), False),
    (dict(head_dim=128, v_dim=64), False),
    (dict(head_dim=128, v_dim=128), True),
    (dict(head_dim=192, v_dim=128, cached=True), False),
    (dict(head_dim=192, v_dim=128, device=CPU), False),
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


# -- the kernel against the plain version, on the card ------------------------

@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_chunked(card, case):
    label, B, S, H, KV, D, causal, shuffled, qk_norm = case
    q, k, v, g, pos = gates.attention_operands(
        B, S, H, KV, D, seed=sum(case[1:6]), device=CUDA, shuffled=shuffled,
        qk_norm=qk_norm)    # QK-norm as an expert share's attention feeds it
    gates.attention_against_plain(q, k, v, g, pos, causal, label)


# multi-head latent attention's variant (q and k 192 wide, v 128) at
# DeepSeek-V2-Lite's microbatch and a ragged one, at its softmax scale:
# (label, B, S, H, D, DV, shuffled positions)
MLA_CARD_CASES = [("dsv2-lite", 2, 4096, 16, 192, 128, False),
                  ("ragged-mla", 1, 1000, 4, 192, 128, True)]
MLA_SCALE = 0.1147213867929261


@pytest.mark.chip
@pytest.mark.parametrize("case", MLA_CARD_CASES,
                         ids=[c[0] for c in MLA_CARD_CASES])
def test_mla_variant_matches_chunked(card, case):
    label, B, S, H, D, DV, shuffled = case
    q, k, v, g, pos = gates.attention_operands(
        B, S, H, H, D, seed=B + S + H, device=CUDA, shuffled=shuffled,
        v_dim=DV)
    spans.reset()
    gates.attention_against_plain(q, k, v, g, pos, True, label,
                                  scale=MLA_SCALE)
    assert spans.total(f"attn.launches.forward.d{D}v{DV}") == 1
    assert spans.total(f"attn.launches.backward.d{D}v{DV}") == 1


# the backward on warpgroup products in each variant: lengths that are no
# multiple of its key or query steps (64, or 32 at D = 192) nor of a
# block's 128, GQA with four query heads to a KV head, causal and full; each
# case held to the plain version and repeated bitwise
# (label, B, S, H, KV, D, DV, causal, shuffled positions, scale)
BACKWARD_CASES = [
    ("d64-full-ragged", 1, 777, 8, 8, 64, 64, False, True, None),
    ("d128-gqa4-ragged", 1, 1000, 16, 4, 128, 128, True, True, None),
    ("d128-full-gqa4", 2, 333, 8, 2, 128, 128, False, False, None),
    ("d192v128-ragged", 1, 1000, 4, 4, 192, 128, True, False, MLA_SCALE),
    ("d192v128-full", 1, 300, 4, 4, 192, 128, False, True, MLA_SCALE)]


@pytest.mark.chip
@pytest.mark.parametrize("case", BACKWARD_CASES,
                         ids=[c[0] for c in BACKWARD_CASES])
def test_backward_matches_chunked_and_repeats(card, case):
    label, B, S, H, KV, D, DV, causal, shuffled, scale = case
    q, k, v, g, pos = gates.attention_operands(
        B, S, H, KV, D, seed=S + H + KV, device=CUDA, shuffled=shuffled,
        v_dim=DV)
    gates.attention_against_plain(q, k, v, g, pos, causal, label,
                                  scale=scale)
    gates.attention_repeats(q, k, v, g, pos, causal, label, scale=scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_is_exact(seed):
    """The backward's premise, on the CPU: a TF32 value x (an fp32 value
    with its low 13 bits clear) is hi + lo with hi = x with its low 16 bits
    clear and lo = x - hi, both bf16 values, and for any bf16 b the fp32
    products hi * b and lo * b are exact, so hi * b + lo * b is x * b
    exactly (in fp64, which holds every such sum)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(1 << 16, generator=gen) * torch.exp2(
        torch.randint(-60, 60, (1 << 16,), generator=gen).float())
    x = (x.view(torch.int32) & ~0x1FFF).view(F32)            # TF32 values
    hi = (x.view(torch.int32) & ~0xFFFF).view(F32)
    lo = x - hi
    assert torch.equal(hi.to(BF).float(), hi)
    assert torch.equal(lo.to(BF).float(), lo)                # exact in bf16
    b = torch.randn(1 << 16, generator=gen).to(BF).float()
    for part in (hi, lo):
        assert torch.equal((part * b).double(), part.double() * b.double())
    assert torch.equal((hi * b).double() + (lo * b).double(),
                       x.double() * b.double())


# -- the kernel against the reference package, through a recorded reading ----
#
# The reference's ``chunked_attention`` (JAX) runs only on the CPU, and the
# kernel only on the card, so the reference's output and gradients at three
# small shapes are recorded in ``REFERENCE`` from inputs that numpy's PCG64
# draws the same on any host.  On the CPU, the recording is held to the
# reference run again and the port's plain version to the recording; on the
# card, the kernel to the recording by ``gates.hold_attention``'s two gates.

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
    plain = gates.attention_grads(lambda a, b, c: layers.chunked_attention(
        a, b, c, causal=causal, q_positions=pos, kv_positions=pos,
        q_chunk=1024, kv_chunk=2048), q, k, v, g)
    gates.hold_attention(plain, _recorded(case),
                         gates.exact_attention(q, k, v, g, pos, causal))


@pytest.mark.parametrize("name", NAMES)
def test_gates_refuse_one_wrong_head(name):
    """The gates the kernel is held to catch one head of one output gone
    wrong: the plain version on the CPU with one head's values of ``name``
    scaled by 1.1, against the reference's recording."""
    case = REF_CASES[0]
    q, k, v, g, pos = _ref_inputs(case)
    plain = gates.attention_grads(lambda a, b, c: layers.chunked_attention(
        a, b, c, causal=case[6], q_positions=pos, kv_positions=pos,
        q_chunk=1024, kv_chunk=2048), q, k, v, g)
    plain[NAMES.index(name)][:, :, 1] *= 1.1
    with pytest.raises(AssertionError, match=rf"\['{name}'\] fail"):
        gates.hold_attention(plain, _recorded(case), gates.exact_attention(
            q, k, v, g, pos, case[6]))


@pytest.mark.chip
@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_kernel_matches_recorded_reference(card, case):
    q, k, v, g, pos = (t.to(CUDA) for t in _ref_inputs(case))
    causal = case[6]
    fused = gates.attention_grads(
        lambda a, b, c: kattn.fused_attention(a, b, c, pos, causal=causal),
        q, k, v, g)
    gates.hold_attention(fused, _recorded(case),
                         gates.exact_attention(q, k, v, g, pos, causal))


def write_reference(path=REFERENCE):
    """Record the reference's readings of ``REF_CASES`` at ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{
        f"{case[0]}/{name}": words for case in REF_CASES
        for name, words in _jax_reference(case).items()})


if __name__ == "__main__":      # PYTHONPATH=src python tests/test_torch_attention.py
    write_reference()
    sys.exit(0)
