"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against ``repro.models`` at the smoke configs, in fp32 on the CPU.

Each arch's reference weights (``repro.models.init_params``) are carried
into the port with ``from_reference_params``; the same batch goes through
both.  Tolerance for logits, loss and caches: rtol 1e-4, atol 1e-5.  The
largest differences seen on this host were 9.5e-7 (loss, kimi-k2),
2.6e-6 (prefill logits, pixtral) and 3.5e-6 (decode logits and caches,
zamba2): fp32 reductions in another order, nothing more.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models as R
from repro.configs import (get_config as ref_config,
                           get_smoke_config as ref_smoke,
                           shape_cells as ref_cells,
                           skipped_cells as ref_skipped)
from repro.models.layers import apply_norm as ref_norm
from repro.models.layers import chunked_attention as ref_chunked_attention
from repro.models.layers import logits_last as ref_logits_last
from repro.models.ssd import apply_ssd as ref_apply_ssd
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 shape_cells, skipped_cells)
import repro_torch.models as P
from repro_torch.models.layers import chunked_attention, logits_last
from repro_torch.models.moe import MoE
from repro_torch.models.ssd import apply_ssd, ssd_reference

RTOL, ATOL = 1e-4, 1e-5
CAUSAL = [a for a in ARCH_IDS if get_smoke_config(a).causal]


def make_batch(cfg, B, S, seed):
    """The same inputs for both packages, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend in ("tokens", "patch_embed"):
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S), np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S), np.int32)
        if cfg.frontend == "patch_embed":
            n = cfg.num_frontend_tokens
            batch["patch_embeds"] = rng.normal(
                size=(B, n, cfg.d_model)).astype(np.float32)
            labels[:, :n] = -1
        batch["labels"] = labels
    else:
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S), np.int32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0):
    """(cfg, reference params, the port's model holding them)."""
    cfg = get_smoke_config(arch)
    params = R.init_params(ref_smoke(arch), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, P.from_reference_params(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(ref_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(ref_smoke(arch))
    assert shape_cells(arch) == ref_cells(arch)
    assert skipped_cells(arch) == ref_skipped(arch)
    assert get_config(arch).param_count() == ref_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_and_layout(arch):
    """The port's own init has the reference's tensors: the same count as
    ``param_count()``, and after a round trip the reference's shapes and
    dtypes leaf for leaf."""
    cfg, params, _ = pair(arch)
    model = P.init_params(cfg, 0, device="cpu")
    sd = model.state_dict()
    assert sum(t.numel() for t in sd.values()) == cfg.param_count()
    assert all(torch.isfinite(t.float()).all() for t in sd.values())
    mine = jax.tree_util.tree_map(np.shape, P.to_reference_params(model))
    want = jax.tree_util.tree_map(np.shape, params)
    assert mine == want
    dtypes = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: str(np.asarray(a).dtype), params))
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: str(a.dtype), P.to_reference_params(model))) == dtypes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_prefill_match_reference(arch):
    cfg, params, model = pair(arch)
    rcfg = ref_smoke(arch)
    batch = make_batch(cfg, 2, 32, seed=1)
    with torch.no_grad():
        got = P.loss_fn(cfg, model, to_torch(batch))
    close(got.numpy(), R.loss_fn(rcfg, params, batch), f"{arch} loss")
    assert math.isfinite(float(got))

    B, S = 2, 16
    batch = make_batch(cfg, B, S, seed=2)
    want, _ = R.prefill(rcfg, params, batch,
                        R.init_cache(rcfg, B, S + 4, dtype=jnp.float32))
    got, _ = P.prefill(cfg, model, to_torch(batch),
                       P.init_cache(cfg, B, S + 4, dtype=torch.float32,
                                    device="cpu"))
    assert got.shape == (B, cfg.vocab_size)
    close(got.numpy(), want, f"{arch} prefill logits")


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_matches_reference(arch):
    """Prefill, then two decode steps: logits and every cache buffer."""
    cfg, params, model = pair(arch)
    rcfg = ref_smoke(arch)
    B, S = 2, 16
    batch = make_batch(cfg, B, S, seed=3)
    rc = R.init_cache(rcfg, B, S + 4, dtype=jnp.float32)
    _, rc = R.prefill(rcfg, params, batch, rc)
    pc = P.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    _, pc = P.prefill(cfg, model, to_torch(batch), pc)
    tok = np.full((B, 1), 3, np.int32)
    for pos in (S, S + 1):
        want, rc = R.decode_step(rcfg, params, rc, jnp.asarray(tok),
                                 jnp.int32(pos))
        got, pc = P.decode_step(cfg, model, pc, torch.from_numpy(tok), pos)
        close(got.numpy(), want, f"{arch} decode logits at {pos}")
    assert sorted(pc) == sorted(rc)
    for key in rc:
        close(pc[key].numpy(), rc[key], f"{arch} cache {key}")


def test_dense_decode_matches_full_forward():
    """Teacher-forced decode equals the parallel forward's next-token
    logits (olmo-1b, rtol = atol = 2e-4, as the reference's own test)."""
    cfg = get_smoke_config("olmo-1b")
    model = P.init_params(cfg, 1, device="cpu")
    B, S = 1, 12
    batch = to_torch(make_batch(cfg, B, S, seed=5))
    toks = batch["tokens"]
    with torch.no_grad():
        h = P.embed_inputs(cfg, model, batch)
        h, _ = P.forward_hidden(cfg, model, h, positions=torch.arange(S))
        want = logits_last(cfg, model.embed, model.final_norm(h))
    cache = P.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    _, cache = P.prefill(cfg, model, {"tokens": toks[:, :S - 1]}, cache)
    got, _ = P.decode_step(cfg, model, cache, toks[:, S - 1:S], S - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def dense_attention(q, k, v, causal):
    """softmax(q k^T / sqrt(D)) v in fp32, KV head h // G for query head h."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)),
                          -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,S,qc,kc", [(4, 4, 24, 8, 8), (8, 2, 30, 7, 12),
                                          (6, 3, 17, 64, 5)])
def test_chunked_attention_matches_dense(causal, H, KV, S, qc, kc):
    rng = np.random.default_rng(S * H)
    q, k, v = (rng.normal(size=(2, S, h, 16)).astype(np.float32)
               for h in (H, KV, KV))
    pos = np.arange(S, dtype=np.int32)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            q_positions=torch.from_numpy(pos),
                            kv_positions=torch.from_numpy(pos), q_chunk=qc,
                            kv_chunk=kc)
    want = dense_attention(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    ref = ref_chunked_attention(q, k, v, causal=causal, q_positions=pos,
                                kv_positions=pos, q_chunk=qc, kv_chunk=kc)
    close(got.numpy(), ref, "against the reference's chunked attention")


@pytest.mark.parametrize("arch,L", [("mamba2-370m", 20), ("mamba2-370m", 8),
                                    ("zamba2-7b", 13)])
def test_apply_ssd_matches_recurrence(arch, L):
    """The chunked SSD (padded when L is not a chunk multiple) equals the
    step-by-step recurrence, and the reference's ``apply_ssd``."""
    cfg, params, model = pair(arch)
    blk = model.blocks[0].ssd
    x = np.random.default_rng(L).normal(size=(2, L, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        got = apply_ssd(cfg, blk, torch.from_numpy(x))
        seq = ssd_reference(cfg, blk, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=RTOL, atol=ATOL)
    ref_blk = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["ssd"])
    close(got.numpy(), ref_apply_ssd(ref_smoke(arch), ref_blk, x),
          "against the reference's apply_ssd")


def test_moe_ties_keep_the_lower_expert():
    """Equal router logits: the lower expert index wins, as with
    ``jax.lax.top_k``."""
    cfg = get_smoke_config("olmoe-1b-7b")
    logits = np.array([[[0.5, 2.0, 2.0, 1.0, 2.0, 0.0, 1.0, 1.0]]],
                      np.float32)
    cfg = dataclasses.replace(cfg, num_experts=logits.shape[-1],
                              experts_per_token=3)
    _, want = jax.lax.top_k(jnp.asarray(logits), 3)
    moe = MoE(cfg, device="cpu")
    x = torch.eye(cfg.d_model)[None, :1]          # one token, x = e_0
    with torch.no_grad():
        moe.router.zero_()
        moe.router[0] = torch.from_numpy(logits[0, 0])
        for w in (moe.we_gate, moe.we_up, moe.we_down):
            w.normal_()
        scores = x.float() @ moe.router
        got = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :3]
        assert got.tolist() == np.asarray(want).tolist() == [[[1, 2, 4]]]
        assert torch.isfinite(moe(x)).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_roundtrip_is_bitwise(arch):
    """to_reference_params(from_reference_params(p)) == p bit for bit, and
    in bf16 through the 16-bit words."""
    for dtype in ("float32", "bfloat16"):
        rcfg = dataclasses.replace(ref_smoke(arch), param_dtype=dtype)
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=dtype)
        params = jax.tree_util.tree_map(
            np.asarray, R.init_params(rcfg, jax.random.PRNGKey(7)))
        model = P.from_reference_params(cfg, params, device="cpu")
        back = P.to_reference_params(model)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(params)):
            if b.dtype == jnp.bfloat16:
                a = a.view(jnp.bfloat16)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_norms_match_reference():
    x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32)
    for name in ("olmo-1b", "hubert-xlarge", "yi-6b"):
        cfg, params, model = pair(name)
        got = model.final_norm(torch.from_numpy(x))
        want = ref_norm(ref_smoke(name), params["final_norm"], x)
        close(got.detach().numpy(), want, f"{name} {cfg.norm}")
    h = np.random.default_rng(1).normal(size=(2, 4, 64)).astype(np.float32)
    got = logits_last(cfg, model.embed, torch.from_numpy(h))
    close(got.detach().numpy(), ref_logits_last(ref_smoke(name),
                                                params["embed"], h),
          "logits_last")
