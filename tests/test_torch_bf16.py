"""The port's LM stack against ``repro.models`` in bf16 (``param_dtype`` and
``compute_dtype`` bfloat16, the dtype of every full config and of the
card's training and serving runs), at the 10 smoke configs, from the
reference's weights, with the shapes of ``test_torch_models.make_batch``:
loss at B=2, S=32; prefill at B=2, S=16, a cache of S+4.

The two packages do not round alike, and the gap is the reference's: under
the default XLA flags (``--xla_allow_excess_precision`` on) XLA keeps bf16
intermediates of fused operations in fp32, while the port rounds each
operation's result to bf16.  With the flag off, 9 archs' logits agreed
within 4.8e-7 in a scratch probe (ROADMAP C9); the flag cannot be set
reliably in a test process where jax has already started, so this test
runs under the default flags and states its tolerances in bf16 ulps of the
largest |logit| (u = 2^(floor(log2 max|logit|) - 7)): prefill logits
within 4 u (up to 2.28 u seen, qwen1.5-0.5b), the loss within u / 4 (up
to 0.164 u seen, olmoe).  The decode step, after a prefill, is held to
the reference's ``decode_step`` at every causal smoke config with the
prefill's tolerance, each package on its own cache (ROADMAP C10).

``fp32_product`` (the products of bf16 values that the reference asks for
in fp32) is tested here too: its plain version is bitwise the upcast
product it replaced, forward and backward; the card version is chosen for
bf16 values on a CUDA device only; and its hand-written backward, run on
CPU tensors (TF32 applies on the card only), gives autograd's gradients.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models as R
from repro.configs import get_smoke_config as ref_smoke
import repro_torch.models as P
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import layers
from repro_torch.models.layers import dt, fp32_product, on_tensor_cores
from test_torch_models import make_batch, to_torch
from test_torch_train import one_torch_thread  # noqa: F401

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
LOGIT_ULPS, LOSS_ULPS = 4.0, 0.25
CAUSAL = [a for a in ARCH_IDS if get_smoke_config(a).causal]
DECODE_STEPS = 4
# the four products, at smoke widths: attention scores and values, the
# decode logits and the loss's chunk (the last two against a table's
# transpose, as the call sites pass it)
SITES = [("bhgqd,bhkd->bhgqk", (2, 2, 2, 8, 16), (2, 2, 8, 16)),
         ("bhgqk,bhkd->bhgqd", (2, 2, 2, 8, 8), (2, 2, 8, 16)),
         (None, (2, 64), (256, 64)),
         (None, (2, 16, 64), (256, 64))]


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@functools.lru_cache(maxsize=None)
def bf16_pair(arch):
    rcfg = dataclasses.replace(ref_smoke(arch), **BF16)
    cfg = dataclasses.replace(get_smoke_config(arch), **BF16)
    params = jax.jit(R.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0))
    model = P.from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return rcfg, cfg, params, model


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_loss_and_prefill_match_reference(arch):
    rcfg, cfg, params, model = bf16_pair(arch)
    assert all(p.dtype == torch.bfloat16 or name.endswith(
        ("A_log", ".D", "dt_bias", "router"))
        for name, p in model.named_parameters())
    B, S = 2, 16
    batch = make_batch(cfg, B, S, seed=2)
    want, _ = jax.jit(lambda p, b, c: R.prefill(rcfg, p, b, c))(
        params, batch, R.init_cache(rcfg, B, S + 4, dtype=jnp.bfloat16))
    got, _ = P.prefill(cfg, model, to_torch(batch),
                       P.init_cache(cfg, B, S + 4, dtype=torch.bfloat16,
                                    device="cpu"))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    u = bf16_ulp(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_ULPS * u, (arch, err / u)

    batch = make_batch(cfg, 2, 32, seed=1)
    with torch.no_grad():
        loss = float(P.loss_fn(cfg, model, to_torch(batch)))
    want_loss = float(jax.jit(lambda p, b: R.loss_fn(rcfg, p, b))(
        params, batch))
    assert abs(loss - want_loss) <= LOSS_ULPS * u, (arch, loss, want_loss)


@pytest.mark.parametrize("arch", CAUSAL)
def test_bf16_decode_matches_reference(arch):
    """Prefill B=2, S=16, then 4 decode steps of tokens drawn with numpy,
    each package on its own cache: every step's logits within
    ``LOGIT_ULPS`` bf16 ulps of the reference's largest |logit|."""
    rcfg, cfg, params, model = bf16_pair(arch)
    B, S = 2, 16
    batch = make_batch(cfg, B, S, seed=3)
    rc = R.init_cache(rcfg, B, S + DECODE_STEPS, dtype=jnp.bfloat16)
    _, rc = jax.jit(lambda p, b, c: R.prefill(rcfg, p, b, c))(
        params, batch, rc)
    pc = P.init_cache(cfg, B, S + DECODE_STEPS, dtype=torch.bfloat16,
                      device="cpu")
    P.prefill(cfg, model, to_torch(batch), pc)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (DECODE_STEPS, B, 1), np.int32)
    step = jax.jit(lambda p, c, t, pos: R.decode_step(rcfg, p, c, t, pos))
    for i in range(DECODE_STEPS):
        want, rc = step(params, rc, jnp.asarray(toks[i]), jnp.int32(S + i))
        got, _ = P.decode_step(cfg, model, pc, torch.from_numpy(toks[i]),
                               S + i)
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.isfinite(got).all() and got.shape == want.shape
        u = bf16_ulp(float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= LOGIT_ULPS * u, (arch, S + i, err / u)


def site_operands(eq, sa, sb, dtype, seed=0):
    """Operands of ``dtype`` and an upstream gradient for one site; at a
    matmul site ``b`` is a table whose transpose is multiplied."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=sa).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=sb).astype(np.float32)).to(dtype)
    out = (torch.einsum(eq, a.float(), b.float()) if eq else
           a.float() @ b.float().t())
    g = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32))
    return a, b, g


def product_and_grads(product, eq, a, b, g):
    """``product`` of the upcast operands (``b``'s transpose at a matmul
    site), and the gradients that reach ``a`` and ``b`` through the
    upcast."""
    a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = product(a.float(), b.float() if eq else b.float().t())
    out.backward(g)
    return out, a.grad, b.grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("eq,sa,sb", SITES)
def test_fp32_product_plain_is_the_upcast_product(eq, sa, sb, dtype):
    a, b, g = site_operands(eq, sa, sb, dtype)
    got = product_and_grads(
        lambda x, y: fp32_product(x, y, eq, dtype=dtype), eq, a, b, g)
    want = product_and_grads(
        lambda x, y: torch.einsum(eq, x, y) if eq else x @ y, eq, a, b, g)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_card_version_is_chosen_for_bf16_values_on_cuda_only(monkeypatch):
    """The selection itself (the card version cannot run here): bf16
    values on a CUDA device, never fp32 values (every smoke config) nor
    any value on the CPU; and a bf16 loss on the CPU never reaches it."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert on_tensor_cores(cuda, torch.bfloat16)
    for dtype in (torch.float32, torch.float16):
        assert not on_tensor_cores(cuda, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        assert not on_tensor_cores(cpu, dtype)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        assert cfg.compute_dtype == "float32"
        assert not on_tensor_cores(cuda, dt(cfg))
        assert on_tensor_cores(cuda, dt(dataclasses.replace(cfg, **BF16)))

    def refuse(*args):
        raise AssertionError("the card version ran on the CPU")

    monkeypatch.setattr(layers._TF32Product, "apply", refuse)
    _, cfg, _, model = bf16_pair("olmo-1b")
    loss = P.loss_fn(cfg, model, to_torch(make_batch(cfg, 2, 32, seed=1)))
    loss.backward()
    model.zero_grad(set_to_none=True)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("eq,sa,sb", SITES)
def test_card_version_gradients(eq, sa, sb):
    """The card version's forward and hand-written backward on CPU tensors
    of fp32 values: the forward bitwise the plain product, the gradients
    within rtol 1e-5 and atol 1e-5 (unit-normal operands) of autograd's,
    which sum in another order."""
    a, b, g = site_operands(eq, sa, sb, torch.float32)
    got = product_and_grads(
        lambda x, y: layers._TF32Product.apply(x, y, eq), eq, a, b, g)
    want = product_and_grads(
        lambda x, y: torch.einsum(eq, x, y) if eq else x @ y, eq, a, b, g)
    assert torch.equal(got[0], want[0])
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
