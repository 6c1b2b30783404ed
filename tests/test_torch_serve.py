"""The port's train loop and serving engine (``repro_torch.train.train``,
``repro_torch.serve``) on the CPU: the reference's 4 tests of
``tests/test_train_serve.py`` at the same tiny config, within the port, and
greedy serving against the reference's ``ServeEngine`` for the reference's
weights.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as R
import repro.serve as RS
from repro.configs import get_smoke_config as ref_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.models import (embed_inputs, forward_hidden,
                                from_reference_params, init_params)
from repro_torch.models.layers import logits_last
from repro_torch.serve import Completion, Request, ServeEngine
from repro_torch.train import DataConfig, LoopConfig, OptimizerConfig, train
from test_torch_train import one_torch_thread  # noqa: F401

TIE_GAP = 1e-5      # a greedy tie may break either way below this top-2 gap


def tiny_cfg():
    cfg = get_smoke_config("olmo-1b")
    return dataclasses.replace(cfg, num_layers=2, d_model=32, d_ff=64,
                               vocab_size=64, num_heads=2, num_kv_heads=2,
                               head_dim=16)


def test_loss_decreases():
    r = train(tiny_cfg(), DataConfig(batch=8, seq_len=32),
              OptimizerConfig(lr=3e-3),
              LoopConfig(steps=30, ckpt_every=50, log_every=100,
                         blocks_per_host=4),
              log=lambda s: None, device="cpu")
    first = np.mean(r.losses[:5])
    last = np.mean(r.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_failure_recovery_is_bit_identical():
    """A run with a host failure after step 13, an FTR regeneration of its
    shard and a restore from the step-8 checkpoint replays the
    uninterrupted run: on the CPU the losses and the final parameters and
    moments are bitwise equal (the reference's own test holds the last
    losses to rtol 1e-5, atol 1e-6)."""
    kw = dict(model_cfg=tiny_cfg(),
              data_cfg=DataConfig(batch=4, seq_len=32),
              opt_cfg=OptimizerConfig(lr=1e-3),
              log=lambda s: None, device="cpu")
    loop = LoopConfig(steps=24, ckpt_every=8, log_every=100,
                      blocks_per_host=4)
    base = train(loop_cfg=loop, **kw)
    failed = train(loop_cfg=loop, fail_at={13: 3}, scheme="ftr", **kw)
    assert len(failed.recoveries) == 1
    assert failed.recoveries[0].decision.plan.scheme == "ftr"
    assert failed.steps_run == base.steps_run + 14 - 8
    np.testing.assert_allclose(base.losses[-4:], failed.losses[-4:],
                               rtol=1e-5, atol=1e-6)
    assert failed.losses[:14] == base.losses[:14]
    assert failed.losses[14:] == base.losses[8:]
    sd_a = base.final_state["params"].state_dict()
    sd_b = failed.final_state["params"].state_dict()
    assert all(torch.equal(sd_a[n], sd_b[n]) for n in sd_a)
    opt_a, opt_b = base.final_state["opt"], failed.final_state["opt"]
    assert int(opt_a.step) == int(opt_b.step) == 24
    assert all(torch.equal(opt_a.m[n], opt_b.m[n]) and
               torch.equal(opt_a.v[n], opt_b.v[n]) for n in opt_a.m)


def test_serving_engine_batches():
    """5 requests over 3 slots; per-slot stopping at ``max_new_tokens``."""
    cfg = tiny_cfg()
    model = init_params(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, model, slots=3, max_len=64, device="cpu")
    reqs = [Request(prompt=[1, 2, 3][: 1 + i % 3], max_new_tokens=2 + i,
                    temperature=0.8 * (i % 2), rid=i) for i in range(5)]
    outs = eng.generate(reqs)
    assert [o.rid for o in outs] == list(range(5))
    for r, o in zip(reqs, outs):
        assert isinstance(o, Completion)
        assert len(o.tokens) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in o.tokens)
    again = ServeEngine(cfg, model, slots=3, max_len=64, seed=0,
                        device="cpu").generate(reqs)
    assert [o.tokens for o in again] == [o.tokens for o in outs]


def test_serving_greedy_matches_forward():
    """Greedy decode of the engine equals argmax of the parallel forward."""
    cfg = tiny_cfg()
    model = init_params(cfg, 1, device="cpu")
    prompt = [5, 9, 11, 2]
    eng = ServeEngine(cfg, model, slots=1, max_len=32, device="cpu")
    out = eng.generate([Request(prompt=prompt, max_new_tokens=6)])[0]
    seq = prompt + out.tokens
    with torch.no_grad():
        h = embed_inputs(cfg, model, {"tokens": torch.tensor([seq])})
        h, _ = forward_hidden(cfg, model, h,
                              positions=torch.arange(len(seq)))
        h = model.final_norm(h)
        for t in range(len(out.tokens)):
            end = len(prompt) + t
            want = int(torch.argmax(logits_last(cfg, model.embed,
                                                h[:, :end])[0]))
            assert out.tokens[t] == want, t


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-370m"])
def test_greedy_serving_matches_reference(arch):
    """The port's engine and the reference's, from the reference's weights
    (fp32 smoke config at a narrow width), on mixed prompt lengths (left
    padding) and more requests than slots: greedy tokens equal.  Where the
    reference's two largest logits at a position differ by under 1e-5, a
    tie may break the other way; the two completions are compared up to
    that position only, and no such tie may occur without that gap."""
    narrow = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=96)
    rcfg = dataclasses.replace(ref_smoke(arch), **narrow)
    cfg = dataclasses.replace(get_smoke_config(arch), **narrow)
    params = jax.jit(R.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(3))
    model = from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 96, size=n).tolist(), m)
            for n, m in [(3, 6), (9, 4), (5, 6), (1, 6), (7, 5), (4, 3),
                         (8, 6)]]
    ref = RS.ServeEngine(rcfg, params, slots=3, max_len=32)
    logits_seen = []
    sample = ref._sample
    ref._sample = lambda lg, t: (logits_seen.append(np.asarray(lg)),
                                 sample(lg, t))[1]
    want = ref.generate([RS.Request(prompt=p, max_new_tokens=m, rid=i)
                         for i, (p, m) in enumerate(reqs)])
    got = ServeEngine(cfg, model, slots=3, max_len=32, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=m, rid=i)
         for i, (p, m) in enumerate(reqs)])
    assert [c.rid for c in got] == [c.rid for c in want]
    # the reference's sample calls, in its scheduler's order: per chunk,
    # every slot after the prefill, then each unfinished slot a step
    gaps = {}
    calls = iter(logits_seen)
    for c0 in range(0, len(reqs), 3):
        chunk = list(range(c0, min(c0 + 3, len(reqs))))
        n = {i: 0 for i in chunk}
        for i in chunk:
            gaps[(i, 0)] = next(calls)
            n[i] = 1
        for _ in range(1, max(reqs[i][1] for i in chunk)):
            for i in chunk:
                if n[i] < reqs[i][1]:
                    gaps[(i, n[i])] = next(calls)
                    n[i] += 1
    assert next(calls, None) is None
    for (i, t), lg in gaps.items():
        top2 = np.sort(lg)[-2:]
        gaps[(i, t)] = top2[1] - top2[0]
    for g, w in zip(got, want):
        assert len(g.tokens) == len(w.tokens) == reqs[g.rid][1]
        for t, (a, b) in enumerate(zip(g.tokens, w.tokens)):
            if a != b:
                assert gaps[(g.rid, t)] < TIE_GAP, (g.rid, t)
                break
