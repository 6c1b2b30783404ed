"""Shared neural layers: norm, rotary embeddings, SwiGLU, chunked attention,
embeddings and the chunked cross entropy (the counterpart of
``repro.models.layers``).

Each layer is an ``nn.Module`` holding its parameters under the reference's
names and shapes (``wq`` is (d, H, hd), ``wo`` (H, hd, d), ...), so the
reference's parameters load one for one (``models.convert``).  The math is
in plain functions on tensors:

  * ``chunked_attention`` — the online-softmax attention over query and KV
    chunks (Python loops over the chunks), so a long prefill never holds
    the S x S scores: the live tile is (B, KV, G, q_chunk, kv_chunk) fp32;
  * ``attention`` — the route: a sequence over itself in bf16 on the card
    (training, prefill) runs on the fused Hopper kernel
    (``kernels.attention``: the same arithmetic with no score tile in
    device memory) where ``fused_attention_engages`` holds, everything else
    (the CPU, fp32, decode over a cache, other head dimensions) on
    ``chunked_attention``; the counters ``attn.fused`` and ``attn.chunked``
    (``obs.spans``) count the calls of each route;
  * ``chunked_softmax_xent`` — loops over sequence chunks so only
    (B, chunk, V) logits are ever live.

Softmax and logsumexp math is fp32, matmul inputs are ``compute_dtype``.
Where the reference asks XLA for an fp32 product of ``compute_dtype``
inputs (``preferred_element_type``), the port upcasts the inputs and
multiplies in fp32 (``fp32_product``): a product of two bf16 values is
exact in fp32, so this is the same arithmetic; on the card, bf16 values
multiply on the tensor cores in TF32, which holds them exactly.

The reference's sharding hints stand at its points (``distributed.hints``):
without an ambient mesh they return their input, so a plain run is what it
was.  With DTensor inputs every op here runs through DTensor's sharding
propagation, but for attention, which runs on each device's (batch,
kv-head) shards (``batch_local``: the chunked version's einsums over the
flattened batch and heads have no DTensor rule once both are sharded, and
the kernel takes plain tensors); the tensors a
layer makes for itself (rope tables, masks, the loss's sums) join the
input's mesh as ``Replicate()``, and the online softmax's running max, sum
and accumulator are made ``*_like`` a tile.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..device import DeviceLike
from ..distributed.hints import (BATCH, batch_local, gathered, hint,
                                 replicate_like)
from ..kernels.attention import fused_attention, fused_attention_engages
from ..obs import spans
from .config import ModelConfig

_MASK = -1e30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

Cache = Tuple[torch.Tensor, torch.Tensor]


def dt(cfg: ModelConfig, kind: str = "compute") -> torch.dtype:
    return _DTYPES[cfg.compute_dtype if kind == "compute" else cfg.param_dtype]


def param(shape, dtype: torch.dtype, device: DeviceLike) -> nn.Parameter:
    """An uninitialised parameter; ``transformer.init_params`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# fp32 products of compute-dtype values
# ---------------------------------------------------------------------------

def on_tensor_cores(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether ``fp32_product`` of values of ``dtype`` on ``device`` runs on
    the tensor cores: bf16 values on a CUDA device.  fp32 values, and every
    value on the CPU, keep the plain fp32 product."""
    return device.type == "cuda" and dtype == torch.bfloat16


@contextlib.contextmanager
def _tf32():
    flags = torch.backends.cuda.matmul
    was = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = was


def _product(a: torch.Tensor, b: torch.Tensor, eq: Optional[str]
             ) -> torch.Tensor:
    return a @ b if eq is None else torch.einsum(eq, a, b)


class _TF32Product(torch.autograd.Function):
    """``_product`` with TF32 allowed in its forward and in its backward (a
    flag set around a forward does not reach autograd's backward)."""

    @staticmethod
    def forward(ctx, a, b, eq):
        ctx.save_for_backward(a, b)
        ctx.eq = eq
        with _tf32():
            return _product(a, b, eq)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _tf32():
            if ctx.eq is None:          # a (..., k) @ b (k, n)
                if ctx.needs_input_grad[0]:
                    ga = g @ b.t()
                if ctx.needs_input_grad[1]:
                    gb = (a.reshape(-1, a.shape[-1]).t()
                          @ g.reshape(-1, g.shape[-1]))
            else:                       # every index of a in b or the output
                x, rest = ctx.eq.split(",")
                y, z = rest.split("->")
                if ctx.needs_input_grad[0]:
                    ga = torch.einsum(f"{z},{y}->{x}", g, b)
                if ctx.needs_input_grad[1]:
                    gb = torch.einsum(f"{x},{z}->{y}", a, g)
        return ga, gb, None


def fp32_product(a: torch.Tensor, b: torch.Tensor, eq: Optional[str] = None,
                 *, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` (``b`` 2-D) or ``torch.einsum(eq, a, b)`` of fp32 operands
    that hold values of ``dtype``, the compute dtype they were upcast from:
    the reference's product of ``dtype`` operands with
    ``preferred_element_type=jnp.float32``.

    The plain version, on the CPU and for fp32 values anywhere, is that
    fp32 product; a product of two bf16 values is exact in fp32, so it is
    the reference's arithmetic.  The card version (``on_tensor_cores``:
    bf16 values on a CUDA device) is the same product with TF32 allowed,
    forward and backward, so it runs on the tensor cores with fp32
    accumulation and output: a bf16 value is exact in TF32, so the forward
    changes only the order of the sums; the backward rounds its fp32
    gradient operand to TF32's 10 bits (the reference's TPU rounds it to
    bf16's 7 at its default precision)."""
    if on_tensor_cores(a.device, dtype):
        return _TF32Product.apply(a, b, eq)
    return _product(a, b, eq)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or nonparam_ln
    (no parameters); the epsilon is the configuration's ``norm_eps`` where
    it has one (``MoEShareConfig``), else ``apply_norm``'s."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.kind = cfg.norm
        self.eps = getattr(cfg, "norm_eps", None)
        if self.kind != "nonparam_ln":
            self.scale = param((cfg.d_model,), dt(cfg, "param"), device)
        if self.kind == "layernorm":
            self.bias = param((cfg.d_model,), dt(cfg, "param"), device)

    def reset(self, gen: torch.Generator) -> None:
        if self.kind != "nonparam_ln":
            self.scale.fill_(1.0)
        if self.kind == "layernorm":
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.kind, x, getattr(self, "scale", None),
                          getattr(self, "bias", None), self.eps)


def apply_norm(kind: str, x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor] = None,
               eps: Optional[float] = None) -> torch.Tensor:
    """Over the last dimension, in fp32, cast back to x's dtype; ``eps``
    defaults to the reference's 1e-6 (rmsnorm) and 1e-5 (the others)."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + (1e-6 if eps is None else eps))
        y = y * scale.float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + (1e-5 if eps is None else eps))
        if kind == "layernorm":
            y = y * scale.float() + bias.float()
        # nonparam_ln (olmo): no affine parameters
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integers.  The half-split
    layout: the first D/2 features pair with the last D/2."""
    d = x.shape[-1]
    assert d % 2 == 0
    freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d))
    ang = positions.float()[..., None] * freq          # (..., S, D/2)
    cos = replicate_like(x, torch.cos(ang)[..., None, :])  # (..., S, 1, D/2)
    sin = replicate_like(x, torch.sin(ang)[..., None, :])
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 d_ff: Optional[int] = None):
        super().__init__()
        f, d = d_ff or cfg.d_ff, cfg.d_model
        self.cfg = cfg
        pd = dt(cfg, "param")
        self.w_gate = param((d, f), pd, device)
        self.w_up = param((d, f), pd, device)
        self.w_down = param((f, d), pd, device)

    def reset(self, gen: torch.Generator) -> None:
        d, f = self.w_gate.shape
        self.w_gate.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.w_up.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.w_down.normal_(0.0, 1.0 / math.sqrt(f), generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = dt(self.cfg)
        xc = x.to(c)
        nb = (None,) * (x.dim() - 2)
        g = hint(xc @ self.w_gate.to(c), BATCH, *nb, "model")
        u = hint(xc @ self.w_up.to(c), BATCH, *nb, "model")
        h = F.silu(g.float()).to(c) * u
        return h @ self.w_down.to(c)


# ---------------------------------------------------------------------------
# Flash-style chunked attention
# ---------------------------------------------------------------------------

def _divisor_chunk(want: int, n: int) -> int:
    """The largest chunk <= min(want, n) that divides n (the reference's
    shrinking loop)."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def _heads_divide(q: DTensor, k: DTensor) -> bool:
    """Whether the query and KV heads both split evenly over "model" (then
    each device's query heads read its own KV heads)."""
    m = dict(zip(q.device_mesh.mesh_dim_names, q.device_mesh.shape))
    n = m.get("model", 1)
    return q.shape[2] % n == 0 and k.shape[2] % n == 0


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_positions: torch.Tensor,
                      kv_positions: torch.Tensor, q_chunk: int,
                      kv_chunk: int, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv), the output
    (B, Sq, H, Dv); H = KV * G (GQA: query head h reads KV head h // G).
    The scores are scaled by ``scale``, 1/sqrt(D) unless given (an fp32
    multiply).  q_positions (Sq,) and kv_positions (Skv,) give
    the causal mask and, at decode, the cache-validity mask (cache slots
    with a position past the query's are excluded).  Loops over query
    chunks (outer) and KV chunks (inner); scores, the running max and sum
    and the accumulator are fp32, the probabilities are cast to v's dtype
    for the value product, as in the reference.  DTensor operands reach it
    through ``attention``, as each device's (batch, kv-head) shards.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    qc = _divisor_chunk(q_chunk, Sq)
    kc = _divisor_chunk(kv_chunk, Skv)
    nq, nk = Sq // qc, Skv // kc
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qk_dtype = torch.promote_types(q.dtype, k.dtype)

    # (nq, B, KV, G, qc, D): the kv-head dimension on "model", so the score
    # and output tiles compute with sharded heads
    qr = hint(q.reshape(B, nq, qc, KV, G, D).permute(1, 0, 3, 4, 2, 5),
              None, BATCH, "model", None, None, None)
    kr = hint(k.reshape(B, nk, kc, KV, D).permute(1, 0, 3, 2, 4),
              None, BATCH, "model", None, None)       # (nk, B, KV, kc, D)
    vr = hint(v.reshape(B, nk, kc, KV, Dv).permute(1, 0, 3, 2, 4),
              None, BATCH, "model", None, None)
    qp = q_positions.reshape(nq, qc)
    kp = kv_positions.reshape(nk, kc)

    outs = []
    for i in range(nq):
        qt = qr[i].float()                      # (B, KV, G, qc, D)
        o = torch.zeros_like(qt if Dv == D else qt[..., :Dv])
        m = torch.full_like(qt[..., 0], _MASK)  # (B, KV, G, qc)
        l = torch.zeros_like(m)
        for j in range(nk):
            kt, vt = kr[j], vr[j]               # (B, KV, kc, D)
            s = fp32_product(qt, kt.float(), "bhgqd,bhkd->bhgqk",
                             dtype=qk_dtype) * scale
            if causal:
                ok = qp[i][:, None] >= kp[j][None, :]
                s = s.masked_fill(replicate_like(s, ~ok), _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + fp32_product(
                p.to(vt.dtype).float(), vt.float(), "bhgqk,bhkd->bhgqd",
                dtype=vt.dtype)
            m = m_new
        outs.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = hint(torch.stack(outs), None, BATCH, "model", None, None, None)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, Dv)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_positions: torch.Tensor,
              kv_positions: torch.Tensor, q_chunk: int, kv_chunk: int,
              cached: bool, scale: Optional[float] = None) -> torch.Tensor:
    """``chunked_attention``'s function (same arguments; ``cached`` says k
    and v are a KV cache), on the fused kernel where
    ``fused_attention_engages`` holds for these operands (q and k share
    their positions when ``kv_positions`` is ``q_positions``; v's width
    may differ from q's), else on ``chunked_attention``.  DTensor operands
    run on each device's (batch, kv-head) shards, on the route their local
    shards take."""
    if isinstance(q, DTensor):
        heads = "model" if _heads_divide(q, k) else None
        return batch_local(functools.partial(
            attention, causal=causal, q_positions=q_positions,
            kv_positions=kv_positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
            cached=cached, scale=scale), q, k, v,
            spec=(BATCH, None, heads, None))
    if fused_attention_engages(
            q.device, (q.dtype, k.dtype, v.dtype), q.shape[-1], q.shape[1],
            cached=cached, self_attention=kv_positions is q_positions
            and k.shape[1] == q.shape[1], v_dim=v.shape[-1]):
        spans.count("attn.fused")
        return fused_attention(q, k, v, q_positions, causal=causal,
                               scale=scale)
    spans.count("attn.chunked")
    return chunked_attention(q, k, v, causal=causal, q_positions=q_positions,
                             kv_positions=kv_positions, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, scale=scale)


# ---------------------------------------------------------------------------
# GQA attention block (with optional KV cache)
# ---------------------------------------------------------------------------

def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) times w (d, heads, hd): (B, S, heads, hd).  On a mesh
    whose "model" the heads do not divide (the rules leave w's heads
    whole), each device computes every head of its rows: DTensor would
    split the product's (heads x hd) columns inside a head, which cannot
    be unflattened."""
    if isinstance(x, DTensor):
        n = dict(zip(x.device_mesh.mesh_dim_names, x.device_mesh.shape))
        if w.shape[1] % n.get("model", 1):
            wl = gathered(w)
            return batch_local(
                lambda xl: torch.einsum("bsd,dhk->bshk", xl, wl), x)
    return torch.einsum("bsd,dhk->bshk", x, w)


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x (B, S, heads, hd): an RMSNorm over all heads' features together."""
    B, S, n, hd = x.shape
    return apply_norm("rmsnorm", x.reshape(B, S, n * hd), scale, eps=eps) \
        .reshape(B, S, n, hd)


class Attention(nn.Module):
    """GQA attention.  For a configuration with ``qk_norm`` (an expert
    share, ``MoEShareConfig``), OLMoE's QK-norm: a weighted RMSNorm
    (``q_norm``, ``k_norm``) over the whole projected q and the whole
    projected k, before RoPE."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg
        pd = dt(cfg, "param")
        self.wq = param((d, H, hd), pd, device)
        self.wk = param((d, KV, hd), pd, device)
        self.wv = param((d, KV, hd), pd, device)
        self.wo = param((H, hd, d), pd, device)
        if cfg.qkv_bias:
            self.bq = param((H, hd), pd, device)
            self.bk = param((KV, hd), pd, device)
            self.bv = param((KV, hd), pd, device)
        self.qk_norm = getattr(cfg, "qk_norm", False)
        if self.qk_norm:
            self.q_norm = param((H * hd,), pd, device)
            self.k_norm = param((KV * hd,), pd, device)

    def reset(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        s = 1.0 / math.sqrt(cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            w.normal_(0.0, s, generator=gen)
        so = 1.0 / math.sqrt(cfg.num_heads * cfg.head_dim)
        self.wo.normal_(0.0, so, generator=gen)
        if cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()
        if self.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Projected and rotated q (B, S, H, hd), k and v (B, S, KV, hd)."""
        c = dt(self.cfg)
        xc = x.to(c)
        q = _project_heads(xc, self.wq.to(c))
        k = _project_heads(xc, self.wk.to(c))
        v = _project_heads(xc, self.wv.to(c))
        if self.cfg.qkv_bias:
            q = q + self.bq.to(c)
            k = k + self.bk.to(c)
            v = v + self.bv.to(c)
        if self.qk_norm:
            q = _qk_norm(q, self.q_norm, self.cfg.norm_eps)
            k = _qk_norm(k, self.k_norm, self.cfg.norm_eps)
        q = hint(q, BATCH, None, "model", None)
        k = hint(k, BATCH, None, "model", None)
        v = hint(v, BATCH, None, "model", None)
        q = rope(q, positions, self.cfg.rope_theta)
        k = rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[Cache] = None,
                cache_index: Union[None, int, torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x: (B, S, d).  Training/prefill without a cache: ``cache=None``
        (hands back k, v when ``cache_index`` is given).  With a cache
        (k_cache, v_cache) of shape (B, S_max, KV, hd): k and v are written
        into it at ``cache_index`` (in place) and attention runs over all
        of its slots, masked by position.  ``cache_index`` is an int, or a
        0-d integer tensor on the cache's device."""
        cfg = self.cfg
        c = dt(cfg)
        q, k, v = self.qkv(x, positions)
        if cfg.repeat_kv and cache is None and cfg.num_kv_heads < cfg.num_heads:
            G = cfg.num_heads // cfg.num_kv_heads
            k = hint(k.repeat_interleave(G, dim=2), BATCH, None, "model", None)
            v = hint(v.repeat_interleave(G, dim=2), BATCH, None, "model", None)

        new_cache = None
        if cache is not None:
            kc, vc = cache
            S = k.shape[1]
            if isinstance(cache_index, torch.Tensor):
                # never read on the host: a captured decode step replays it
                at = replicate_like(kc, cache_index.long()
                                    + torch.arange(S, device=kc.device))
                kc[:, at] = k.to(kc.dtype)
                vc[:, at] = v.to(vc.dtype)
            else:
                # a slice: the one write DTensor shards in place on every
                # torch the port runs on (2.11 has no in-place rule for
                # index_put_, index_copy_ or scatter_), which the dry run's
                # sharded prefill and decode cells need
                at = int(cache_index)
                kc[:, at:at + S] = k.to(kc.dtype)
                vc[:, at:at + S] = v.to(vc.dtype)
            new_cache = (kc, vc)
            kv_pos = torch.arange(kc.shape[1], dtype=torch.int32,
                                  device=positions.device)
            out = attention(q, kc, vc, causal=True, q_positions=positions,
                            kv_positions=kv_pos, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk, cached=True)
        else:
            out = attention(q, k, v, causal=cfg.causal, q_positions=positions,
                            kv_positions=positions, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk, cached=False)
            if cache_index is not None:  # prefill: hand back k/v for a cache
                new_cache = (k, v)
        y = torch.einsum("bshk,hkd->bsd", out, self.wo.to(c))
        return y, new_cache


# ---------------------------------------------------------------------------
# Embeddings + chunked cross-entropy
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """``tok`` (V, d) for token frontends, ``unembed`` (V, d) unless tied."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        shape, pd = (cfg.vocab_size, cfg.d_model), dt(cfg, "param")
        if cfg.frontend in ("tokens", "patch_embed"):
            self.tok = param(shape, pd, device)
        if not cfg.tie_embeddings or cfg.frontend == "frame_embed":
            self.unembed = param(shape, pd, device)

    def reset(self, gen: torch.Generator) -> None:
        for w in self.parameters():
            w.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=gen)

    def tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if isinstance(self.tok, DTensor):
            return _vocab_parallel(
                lambda table, ids: table[ids], self.tok, tokens, 0,
                tuple(tokens.shape) + (self.tok.shape[1],)).to(dt(self.cfg))
        return self.tok[tokens].to(dt(self.cfg))

    def table(self) -> torch.Tensor:
        return self.unembed if hasattr(self, "unembed") else self.tok


def _vocab_dim(x: DTensor, dim: int) -> Optional[int]:
    """The mesh dimension (of size > 1) that shards ``x``'s vocabulary
    dimension ``dim``, if any; ``x`` is sharded there at most once and
    nowhere else."""
    mesh = x.device_mesh
    dims = [md for md, pl in enumerate(x.placements)
            if pl.is_shard(dim) and mesh.size(md) > 1]
    if len(dims) > 1:
        raise NotImplementedError(f"vocabulary placements {x.placements}")
    return dims[0] if dims else None


def _vocab_parallel(fn, table: DTensor, ids: torch.Tensor, dim: int,
                    shape) -> DTensor:
    """``fn(local table, local ids)`` where ``table``'s vocabulary
    dimension ``dim`` may be sharded over one mesh dimension: each device
    reads the ids its shard holds (zeros for the others), and the devices'
    results are summed over that mesh dimension.  The other placements are
    the ids' for a lookup (``dim`` 0) and the table's for a gather, whose
    leading dimensions are the ids'.  The table's local gradient is a
    partial sum over the mesh dimensions that split the ids but not the
    table (each data shard's rows add to it).  (DTensor's own rules for a
    lookup or a gather on a sharded vocabulary fail in their backward in
    the torch versions at hand: an index_put strategy on 2.11, a
    partial-to-masked-partial redistribution on 2.11 and 2.13.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    vd = _vocab_dim(table, dim)
    if not isinstance(ids, DTensor):
        ids = replicate_like(table, ids)
    keep = [Replicate() if md == vd else pl for md, pl in
            enumerate(ids.placements if dim == 0 else table.placements)]
    local_ids = ids.redistribute(mesh, keep).to_local()
    local = table.to_local(grad_placements=[
        Partial() if keep[md].is_shard() and not pl.is_shard() else pl
        for md, pl in enumerate(table.placements)])
    if vd is None:
        out, placements, shape = fn(local, local_ids), keep, tuple(shape)
    else:
        lo = mesh.get_local_rank(vd) * local.shape[dim]
        held = (local_ids >= lo) & (local_ids < lo + local.shape[dim])
        out = fn(local, torch.where(held, local_ids - lo, 0))
        out = torch.where(held.reshape(held.shape + (1,) * (out.dim()
                                                            - held.dim())),
                          out, torch.zeros_like(out))[None]
        # the shards' results stacked along a new leading dimension, which
        # a sum then reduces
        placements = [Shard(0) if md == vd else
                      Shard(pl.dim + 1) if pl.is_shard() else pl
                      for md, pl in enumerate(keep)]
        shape = (mesh.size(vd),) + tuple(shape)
    shape = torch.Size(shape)
    out = DTensor.from_local(out, mesh, placements, run_check=False,
                             shape=shape,
                             stride=torch.empty(shape, device="meta")
                             .stride())
    return out if vd is None else out.sum(0)


def logits_last(cfg: ModelConfig, embed: Embed, h: torch.Tensor
                ) -> torch.Tensor:
    """Logits for the last position only (decode / prefill output)."""
    table = embed.table()
    return fp32_product(h[:, -1].float(), table.float().t(),
                        dtype=torch.promote_types(h.dtype, table.dtype))


def chunked_softmax_xent(cfg: ModelConfig, embed: Embed, h: torch.Tensor,
                         labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy over sequence chunks, so only
    (B, chunk, V) logits are ever live.  labels: (B, S) integers; positions
    with label < 0 (or mask == 0) are excluded."""
    B, S, d = h.shape
    W = embed.table().to(dt(cfg)).float()
    cs = _divisor_chunk(cfg.loss_chunk, S)
    if mask is None:
        mask = labels >= 0
    tot = replicate_like(h, torch.zeros((), dtype=torch.float32,
                                        device=labels.device))
    cnt = torch.zeros_like(tot)
    for s0 in range(0, S, cs):
        hc = h[:, s0:s0 + cs].to(dt(cfg)).float()
        lc = labels[:, s0:s0 + cs]
        mc = mask[:, s0:s0 + cs].float()
        logits = hint(fp32_product(hc, W.t(), dtype=dt(cfg)), BATCH, None,
                      "model")
        lse = torch.logsumexp(logits, dim=-1)
        idx = torch.clamp(lc, min=0).long()
        if isinstance(logits, DTensor):     # a partial sum: reduce it here
            gold = hint(_vocab_parallel(
                lambda lg, i: torch.gather(lg, -1, i[..., None])[..., 0],
                logits, idx, 2, idx.shape), BATCH, None)
        else:
            gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
