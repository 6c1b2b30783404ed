"""DeepSeek-V2's share (``MLAShareConfig``: multi-head latent attention,
``models.mla``; a leading dense layer; DeepSeekMoE, ``models.moe.
SharedMoEShare``) on the CPU at small sizes, on seeded random weights:

  * the MLA block, and the whole share model's loss, loss parts and every
    leaf's gradient over two microbatches, against the benchmark's plain
    reference (``perfbench/reference/deepseek_v2.py``);
  * the YaRN table against the published formula at a few dimensions,
    and the softmax scale against its published value;
  * ``chunked_attention`` with v narrower than q and k and an explicit
    scale against a dense softmax;
  * the share: four shares' routed parts, plus the shared experts counted
    once, equal the uncut reference layer;
  * the sequence-wise balance loss against a direct count;
  * the fused kernel's build for the (192, 128) variant (its rule is
    among ``test_torch_attention.py``'s), and a CPU step on
    ``chunked_attention`` only, with the routes and counters of an MoE
    step.

Tolerances: fp32 against fp32 on the CPU, sums in another order: rtol
1e-4, atol 1e-5 as in ``test_torch_moe_share.py``.
"""
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import gen_mla                                   # noqa: E402
from perfbench.reference import deepseek_v2 as ref              # noqa: E402
from repro_torch.kernels import attention as kattn              # noqa: E402
from repro_torch.models import (MLAShareConfig, Transformer,    # noqa: E402
                                loss_terms)
from repro_torch.models import mla, moe                         # noqa: E402
from repro_torch.models.layers import chunked_attention         # noqa: E402
from repro_torch.obs import spans                               # noqa: E402

from test_torch_train import one_torch_thread                   # noqa: E402,F401

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(name="dsv2-share-smoke", family="moe", num_layers=3,
             d_model=64, d_ff=32, vocab_size=256, num_heads=4,
             num_kv_heads=4, head_dim=24, norm="rmsnorm",
             rope_theta=10000.0, tie_embeddings=False, num_experts=4,
             experts_per_token=3, router_experts=8, expert_offset=2,
             norm_eps=1e-6, lb_weight=0.001, z_weight=0.0, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             shared_experts=2, first_dense=1, dense_d_ff=96,
             rope_factor=40.0, rope_original=16, beta_fast=32.0,
             beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707,
             param_dtype="float32", compute_dtype="float32", q_chunk=16,
             kv_chunk=16, loss_chunk=16)


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.reset()
    yield
    spans.reset()


def model_of(mdl, seed=3):
    cfg = MLAShareConfig(**mdl)
    model = Transformer(cfg, "cpu")
    w = gen_mla.mla_weights(mdl, seed, "cpu", torch.float32)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return cfg, model, w


def batch_of(vocab, rows=4, seq=32, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, vocab, (rows, seq), generator=g),
            torch.randint(0, vocab, (rows, seq), generator=g))


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("held, offset, dense", [(4, 2, 1), (2, 6, 1),
                                                 (8, 0, 0)])
def test_step_matches_the_reference(held, offset, dense):
    mdl = dict(SMALL, num_experts=held, expert_offset=offset,
               first_dense=dense)
    cfg, model, w = model_of(mdl)
    tokens, labels = batch_of(mdl["vocab_size"])
    parts = {}
    for mb in range(2):
        sl = slice(mb * 2, (mb + 1) * 2)
        terms = loss_terms(cfg, model, {"tokens": tokens[sl],
                                        "labels": labels[sl]})
        terms["loss"].backward()
        for k, v in terms.items():
            parts[k] = parts.get(k, 0.0) + float(v.detach()) / 2
    want, grads, _ = ref.loss_and_grads(w, mdl, tokens, labels, 2)
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        close(parts[k], want[k], k)
    assert parts["z_loss"] == 0.0 and parts["lb_loss"] > 0
    for n, p in model.named_parameters():
        close((p.grad / 2).numpy(), grads[n].numpy(), n)


def test_mla_block_against_the_reference():
    """One block's attention on its own, output and input gradient."""
    mdl = dict(SMALL, num_layers=1, first_dense=1)
    cfg, model, w = model_of(mdl)
    blk = model.blocks[0].attn
    x = torch.randn(2, 32, mdl["d_model"], generator=torch.Generator()
                    .manual_seed(4), requires_grad=True)
    pos = torch.arange(32, dtype=torch.int32)
    y, cache = blk(x, positions=pos)
    assert cache is None and y.shape == x.shape
    g = torch.randn_like(y)
    (y * g).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    yr = torch.stack([_reference_attention(w, mdl, row) for row in xr])
    (yr * g).sum().backward()
    close(y.detach().numpy(), yr.detach().numpy(), "MLA output")
    close(x.grad.numpy(), xr.grad.numpy(), "MLA input gradient")


def _reference_attention(w, mdl, x):
    """Layer 0's MLA on x (S, d), written out from the reference's
    helpers (its YaRN table, rotation, latent norm and softmax scale)."""
    d, H = mdl["d_model"], mdl["num_heads"]
    nope, rd = mdl["qk_nope_head_dim"], mdl["qk_rope_head_dim"]
    dv, r = mdl["v_head_dim"], mdl["kv_lora_rank"]
    s = x.shape[0]
    cos, sin = ref.yarn_cos_sin(mdl, s, "cpu")
    q = (x @ w["blocks.0.attn.wq"].reshape(d, -1)).reshape(s, H, nope + rd)
    kv_a = x @ w["blocks.0.attn.wkv_a"]
    c = ref._rms(kv_a[:, :r], w["blocks.0.attn.kv_norm"], mdl["norm_eps"])
    kv = (c @ w["blocks.0.attn.wkv_b"].reshape(r, -1)).reshape(s, H, -1)
    q = torch.cat([q[..., :nope], ref._rope(q[..., nope:], cos, sin)], -1)
    k = torch.cat([kv[..., :nope], ref._rope(kv_a[:, None, r:], cos, sin)
                   .expand(s, H, rd)], -1)
    v = kv[..., nope:]
    sc = torch.einsum("qhd,khd->hqk", q, k) * ref.softmax_scale(mdl)
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v)
    return o.reshape(s, H * dv) @ w["blocks.0.attn.wo"].reshape(H * dv, d)


@pytest.mark.parametrize("dim, base, factor, original, fast, slow", [
    (64, 10000.0, 40.0, 4096, 32.0, 1.0),      # DeepSeek-V2-Lite's
    (64, 10000.0, 4.0, 2048, 32.0, 1.0),
    (32, 500000.0, 8.0, 8192, 16.0, 2.0),
    (8, 10000.0, 40.0, 16, 32.0, 1.0)])        # the smoke share's
def test_yarn_table_against_the_published_formula(dim, base, factor,
                                                  original, fast, slow):
    """yarn_find_correction_dim / range, yarn_linear_ramp_mask and the
    blend of DeepseekV2YarnRotaryEmbedding, written out in float64."""
    def corr(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low, high = max(math.floor(corr(fast)), 0), \
        min(math.ceil(corr(slow)), dim - 1)
    if low == high:
        high += 0.001
    want = []
    for i in range(dim // 2):
        extra = 1.0 / base ** (2 * i / dim)
        mask = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / factor * (1 - mask) + extra * mask)
    got = mla.yarn_inv_freq(dim, base, factor, original, fast, slow)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=2e-6)
    if (dim, factor) == (64, 40.0):
        # the 10 fastest pairs keep theta's frequency, from the 23rd
        # theta's over 40
        assert got[9] == pytest.approx(want[9]) and \
            got[23] == pytest.approx(1.0 / base ** (46 / 64) / 40)


def test_yarn_table_rows_and_scale():
    cfg = MLAShareConfig(**SMALL)
    cos, sin = mla.yarn_table(cfg, 32, torch.device("cpu"))
    assert cos.shape == sin.shape == (32, 1, 4)
    rc, rs = ref.yarn_cos_sin(SMALL, 32, "cpu")
    close(cos.numpy(), rc.numpy(), "cos")
    close(sin.numpy(), rs.numpy(), "sin")
    # DeepSeek-V2-Lite's: 192^-1/2 (1 + 0.1 * 0.707 * ln 40)^2
    lite = MLAShareConfig(**dict(SMALL, head_dim=192, qk_nope_head_dim=128,
                                 qk_rope_head_dim=64))
    assert lite.softmax_scale == pytest.approx(
        192 ** -0.5 * (1 + 0.0707 * math.log(40)) ** 2, rel=1e-12)
    assert round(lite.softmax_scale, 6) == 0.114721


def test_rope_pairs_rotate_interleaved_pairs():
    """Each (2i, 2i + 1) pair is turned by its angle, the results laid out
    [evens; odds]: the norms of the pairs are kept and q.k depends on the
    positions' difference only."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 6, 1, 8, generator=g, dtype=torch.float64)
    k = torch.randn(1, 6, 1, 8, generator=g, dtype=torch.float64)
    inv = torch.tensor([1.0, 0.3, 0.05, 0.01], dtype=torch.float64)
    ang = torch.arange(6, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    rq = mla.rope_pairs(q, cos, sin)
    pair = q[..., 0::2] ** 2 + q[..., 1::2] ** 2
    close((rq[..., :4] ** 2 + rq[..., 4:] ** 2).numpy(), pair.numpy(),
          "pair norms")
    # one q and one k at every position: q_i . k_j depends on i - j only
    qq = mla.rope_pairs(q[:, :1].expand(1, 6, 1, 8), cos, sin)[0, :, 0]
    kk = mla.rope_pairs(k[:, :1].expand(1, 6, 1, 8), cos, sin)[0, :, 0]
    dots = qq @ kk.t()
    close(dots[1:, 1:].numpy(), dots[:-1, :-1].numpy(), "shift invariance")


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_narrow_v_and_scale(causal):
    g = torch.Generator().manual_seed(11)
    B, S, H, KV, D, DV = 2, 24, 4, 2, 24, 16
    q = torch.randn(B, S, H, D, generator=g)
    k = torch.randn(B, S, KV, D, generator=g)
    v = torch.randn(B, S, KV, DV, generator=g)
    pos = torch.arange(S, dtype=torch.int32)
    scale = 0.37
    got = chunked_attention(q, k, v, causal=causal, q_positions=pos,
                            kv_positions=pos, q_chunk=8, kv_chunk=16,
                            scale=scale)
    kd = k.repeat_interleave(H // KV, dim=2)
    vd = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kd) * scale
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    assert got.shape == (B, S, H, DV)
    close(got.numpy(), want.numpy(), "narrow v")
    # no scale given: 1/sqrt(D), as before
    plain = chunked_attention(q, k, k, causal=causal, q_positions=pos,
                              kv_positions=pos, q_chunk=8, kv_chunk=16)
    given = chunked_attention(q, k, k, causal=causal, q_positions=pos,
                              kv_positions=pos, q_chunk=8, kv_chunk=16,
                              scale=1.0 / math.sqrt(D))
    assert torch.equal(plain, given)


def test_four_shares_sum_to_the_uncut_layer():
    E, K = 8, 3
    whole = dict(SMALL, num_experts=E, router_experts=E, expert_offset=0,
                 experts_per_token=K, num_layers=2, first_dense=1)
    cfg, model, w = model_of(whole)
    layer = model.blocks[1].moe
    d = whole["d_model"]
    x = torch.randn(2, 16, d, generator=torch.Generator().manual_seed(9))
    xf = x.reshape(-1, d)
    with torch.no_grad():
        y_ref, *_ = ref.moe_share(xf, w, "blocks.1.moe.", whole)
        y_ref = y_ref + ref._swiglu(xf, w, "blocks.1.moe.shared.",
                                    torch.matmul)
        total = torch.zeros_like(x)
        counted = 0
        for part in range(4):
            mdl = dict(whole, num_experts=E // 4, expert_offset=part * E // 4)
            share = moe.SharedMoEShare(MLAShareConfig(**mdl), "cpu")
            sl = slice(part * E // 4, (part + 1) * E // 4)
            share.router.copy_(layer.router)
            for name in ("we_gate", "we_up", "we_down"):
                getattr(share, name).copy_(getattr(layer, name)[sl])
            share.shared.load_state_dict(layer.shared.state_dict())
            y, _, counts = share.forward_stats(x)
            total += y - share.shared(xf).view_as(y)     # the routed part
            counted += int(counts[0])
        total += layer.shared(xf).view_as(total)        # counted once
        y_whole, _, counts = layer.forward_stats(x)
    close(total.numpy(), y_ref.reshape(x.shape).numpy(), "shares summed")
    close(y_whole.numpy(), y_ref.reshape(x.shape).numpy(), "uncut layer")
    assert counted == int(counts[0]) == x.shape[0] * x.shape[1] * K


def test_sequence_balance_loss_against_a_direct_count():
    g = torch.Generator().manual_seed(6)
    rows, S, E, K = 3, 10, 8, 3
    probs = torch.softmax(torch.randn(rows * S, E, generator=g), -1)
    top = torch.stack([torch.randperm(E, generator=g)[:K]
                       for _ in range(rows * S)])
    want = 0.0
    for r in range(rows):
        t = top[r * S:(r + 1) * S]
        p = probs[r * S:(r + 1) * S]
        for e in range(E):
            f = E / (K * S) * int((t == e).sum())
            want += f * float(p[:, e].mean()) / rows
    got = moe.sequence_balance_loss(probs, top, rows)
    assert float(got) == pytest.approx(want, rel=1e-6)
    # a perfectly balanced sequence reads 1
    flat = torch.full((E, E), 1.0 / E)
    even = torch.arange(E * K).reshape(E, K) % E
    assert float(moe.sequence_balance_loss(flat, even, 1)) == \
        pytest.approx(1.0)


def test_build_of_the_mla_variant(monkeypatch):
    """The (192, 128) variant is a library of its own with v's width as a
    flag; the one-width variants' builds keep their names and flags."""
    seen = []
    monkeypatch.setattr(kattn, "build_library",
                        lambda *job: seen.append(job) or (None, ""))
    kattn.build(192, True, 128)
    kattn.build(128, True, 128)
    (_, stem, flags, _), (_, stem128, flags128, _) = seen
    assert stem == "libattention_d192v128_causal"
    assert {"-DATTN_HEAD_DIM=192", "-DATTN_V_DIM=128",
            "-DATTN_CAUSAL=1"} <= set(flags)
    assert stem128 == "libattention_d128_causal"
    assert not any(f.startswith("-DATTN_V_DIM") for f in flags128)


def test_cpu_step_counts_and_routes():
    """A training loss and its gradient on the CPU: every attention call on
    ``chunked_attention`` (forward and remat's recomputation), none on the
    kernel; the MoE layers' spans and device counters; the dense layer
    holds no router."""
    cfg, model, _ = model_of(SMALL)
    tokens, labels = batch_of(SMALL["vocab_size"], rows=2)
    layers = [blk.moe for blk in model.blocks[cfg.first_dense:]]
    for layer in layers:
        layer.routes = []
    spans.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        loss_terms(cfg, model, {"tokens": tokens,
                                "labels": labels})["loss"].backward()
    L, moe_layers = cfg.num_layers, cfg.num_layers - cfg.first_dense
    assert spans.total("attn.chunked") == 2 * L
    for name in ("attn.fused", "attn.launches.forward"):
        assert spans.total(name) == 0
    s = spans.summary()
    for name in ("moe.route", "moe.shared", "moe.combine"):
        assert s["spans"][name]["calls"] == 2 * moe_layers, name
    assert not hasattr(model.blocks[0], "moe")
    # the forward's held pairs (remat's recomputation routes again, and
    # counts nothing)
    assert all(len(layer.routes) == 2 for layer in layers)
    assert spans.device_total("moe.pairs") == sum(
        int((layer.routes[0] >= 0).sum()) for layer in layers)
    assert spans.device_total("moe.dropped") == 0
