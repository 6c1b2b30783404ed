"""The decode step with its position as a 0-d device tensor, which the
serving engine captures as a CUDA graph on the card
(``repro_torch.serve.graph``), on the CPU at every causal smoke config:

  * the tensor position gives bitwise the logits and caches of an int one,
    which ``test_torch_models.test_decode_matches_reference`` holds to the
    reference's ``decode_step``;
  * the step reads nothing on the host (a captured graph replays no host
    read), under a dispatch mode that raises on every op that would;
  * an engine serving twice reuses its buffers and gives bitwise a fresh
    engine's completions, and a short chunk decoded in the engine's full
    batch gives bitwise the completions of a batch of its own size;
  * the MoE's combine, a fixed-order sum so that a step gives the same
    bits on every run on the card, is bitwise the CPU's ``scatter_add_``.

The graph itself (capture and replay) needs the card: ``chip_smoke.py``
phases 6b, 6b' and 7a hold it to the eager step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.moe import _combine, _dispatch
from repro_torch.serve import DecodeGraph, EagerDecode, Request, ServeEngine
from test_torch_train import one_torch_thread  # noqa: F401

CAUSAL = [a for a in ARCH_IDS if get_smoke_config(a).causal]
TOKEN_ARCHS = [a for a in CAUSAL if get_smoke_config(a).frontend == "tokens"]
B, PROMPT, STEPS, MAX_LEN = 2, 12, 8, 32
aten = torch.ops.aten
HOST_READS = {aten._local_scalar_dense, aten.item, aten.is_nonzero,
              aten.nonzero, aten.lift_fresh}


class NoHostReads(TorchDispatchMode):
    """Raises on an op that reads a tensor on the host or copies a host
    value in (``lift_fresh`` is ``torch.tensor`` of Python data); counts
    the ops it sees."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            raise AssertionError(f"host read: {func}")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def prefilled(arch, seed=0):
    """(cfg, model, a prefilled fp32 cache, the decode tokens (STEPS, B,
    1)), the inputs drawn with numpy."""
    cfg = get_smoke_config(arch)
    model = init_params(cfg, seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, PROMPT), np.int32))}
    if cfg.frontend == "patch_embed":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32))
    cache = init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    prefill(cfg, model, batch, cache)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (STEPS, B, 1), np.int32))
    return cfg, model, cache, toks


@pytest.mark.parametrize("arch", CAUSAL)
def test_tensor_position_is_bitwise_the_int_one(arch):
    cfg, model, cache, toks = prefilled(arch)
    other = {k: v.clone() for k, v in cache.items()}
    for i in range(STEPS):
        pos = PROMPT + i
        want, _ = decode_step(cfg, model, cache, toks[i], pos)
        got, _ = decode_step(cfg, model, other, toks[i],
                             torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want), (arch, pos)
    assert sorted(other) == sorted(cache)
    for key in cache:
        assert torch.equal(other[key], cache[key]), (arch, key)


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_step_reads_nothing_on_the_host(arch):
    cfg, model, cache, toks = prefilled(arch)
    pos = torch.tensor(PROMPT, dtype=torch.int32)
    with pytest.raises(AssertionError, match="host read"), NoHostReads():
        int(pos)                    # the mode sees a host read
    mode = NoHostReads()
    with mode:
        logits, _ = decode_step(cfg, model, cache, toks[0], pos)
    assert mode.ops > 100 and logits.shape == (B, cfg.vocab_size)


def engine_case(arch):
    """A bf16 smoke model and 5 requests, every other one sampled at
    temperature 0.8."""
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=m, temperature=0.8 * (i % 2), rid=i)
            for i, (n, m) in enumerate([(5, 4), (2, 6), (9, 3), (4, 5),
                                        (7, 4)])]
    return cfg, model, reqs


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_engine_reuses_its_buffers(arch):
    """Two ``generate`` calls on one engine (the sampler reseeded between
    them) against a fresh engine: bitwise the same completions, over
    chunks of 3 and 2 requests (one buffer set of 3 rows, built once and
    reused by every chunk)."""
    cfg, model, reqs = engine_case(arch)
    eng = ServeEngine(cfg, model, slots=3, max_len=MAX_LEN, seed=5,
                      device="cpu")
    first = eng.generate(reqs)
    held = eng.decoder
    assert type(held) is EagerDecode and held.tokens.shape == (3, 1)
    eng.gen.manual_seed(5)
    second = eng.generate(reqs)
    assert eng.decoder is held
    fresh = ServeEngine(cfg, model, slots=3, max_len=MAX_LEN, seed=5,
                        device="cpu").generate(reqs)
    assert [c.tokens for c in first] == [c.tokens for c in fresh]
    assert [c.tokens for c in second] == [c.tokens for c in fresh]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_spare_rows_change_no_tokens(arch):
    """A short chunk decodes in the engine's full batch, its spare rows fed
    token 0: its completions are bitwise those of an engine whose batch is
    the chunk (the last 2 of 5 requests on 3 slots, against 2 slots with
    the sampler in the same state)."""
    cfg, model, reqs = engine_case(arch)
    padded = ServeEngine(cfg, model, slots=3, max_len=MAX_LEN, seed=5,
                         device="cpu").generate(reqs)
    head_eng = ServeEngine(cfg, model, slots=3, max_len=MAX_LEN, seed=5,
                           device="cpu")
    head = head_eng.generate(reqs[:3])
    tail_eng = ServeEngine(cfg, model, slots=2, max_len=MAX_LEN, seed=0,
                           device="cpu")
    tail_eng.gen.set_state(head_eng.gen.get_state())
    tail = tail_eng.generate(reqs[3:])
    assert [c.rid for c in padded] == [r.rid for r in reqs]
    assert [c.tokens for c in padded] == [c.tokens for c in head + tail]


def scatter_add_combine(ye, logits, K, cap):
    """The combine as a ``scatter_add_`` over the pairs sorted by expert
    (stably, from token-major order), which the CPU adds in that order."""
    B, E, _, d = ye.shape
    S = logits.shape[1]
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :K], dim=-1).reshape(B, S * K)
    experts = ids[..., :K].reshape(B, S * K)
    tokens = torch.arange(S).repeat_interleave(K).expand(B, S * K)
    order = torch.argsort(experts, dim=1, stable=True)
    e, t, g = (torch.gather(a, 1, order) for a in (experts, tokens, gates))
    pos = torch.arange(S * K)[None] - torch.searchsorted(e, e, side="left")
    keep = pos < cap
    slot = torch.where(keep, e * cap + pos, 0)
    contrib = torch.gather(ye.reshape(B, E * cap, d), 1,
                           slot[..., None].expand(-1, -1, d))
    contrib = torch.where(keep[..., None], contrib, 0.0) * g[..., None]
    return torch.zeros((B, S, d)).scatter_add_(
        1, t[..., None].expand(-1, -1, d), contrib)


@pytest.mark.parametrize("B,S,E,K,cap", [(4, 1, 64, 8, 1), (2, 37, 8, 2, 12),
                                         (2, 64, 16, 4, 5)])
def test_moe_combine_is_the_sequential_scatter_add(B, S, E, K, cap):
    """The MoE's fixed-order combine (the same bits on every run on the
    card) against ``scatter_add_`` over the expert-sorted pairs on the CPU,
    which adds in that order: bitwise, dropped pairs included (cap 5 of
    64 x 4 / 16 pairs an expert)."""
    rng = np.random.default_rng(B * S + cap)
    d = 16
    x = torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32))
    logits = torch.from_numpy(rng.normal(size=(B, S, E)).astype(np.float32))
    _, route = _dispatch(x, logits, K=K, cap=cap, dtype=torch.float32)
    ye = torch.from_numpy(rng.normal(size=(B, E, cap, d)).astype(np.float32))
    assert torch.equal(_combine(ye, *route, S=S),
                       scatter_add_combine(ye, logits, K, cap))


def test_buffers_check_the_position_and_graphs_need_cuda(monkeypatch):
    cfg = get_smoke_config("olmo-1b")
    model = init_params(cfg, 0, device="cpu")
    dec = EagerDecode(cfg, model, B, MAX_LEN, dtype=torch.float32,
                      device="cpu")
    with pytest.raises(IndexError):
        dec(torch.zeros((B, 1), dtype=torch.int32), MAX_LEN)
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(cfg, model, B, MAX_LEN, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (EagerDecode, DecodeGraph):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(cfg, model, B, MAX_LEN)
