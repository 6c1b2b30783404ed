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
    tree's program).

Tolerances: fp32 against fp32 on the CPU, sums in another order (the
program sums a token's experts over its top K, the reference in the
experts' order): rtol 1e-4, atol 1e-5 as in ``test_torch_models.py``.
"""
import hashlib
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import gen_moe                                   # noqa: E402
from perfbench.reference import olmoe as ref                    # noqa: E402
from perfbench.tools.faults_moe import capacity_drop            # noqa: E402
from repro_torch.configs import get_smoke_config                # noqa: E402
from repro_torch.models import (MoEShareConfig, Transformer,    # noqa: E402
                                init_params, loss_terms)
from repro_torch.models import moe as moe_mod                   # noqa: E402
from repro_torch.models.layers import apply_norm, rope          # noqa: E402
from repro_torch.obs import spans                               # noqa: E402
from repro_torch.train import (OptimizerConfig, init_opt,       # noqa: E402
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
