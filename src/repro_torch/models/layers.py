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
  * ``chunked_softmax_xent`` — loops over sequence chunks so only
    (B, chunk, V) logits are ever live.

Softmax and logsumexp math is fp32, matmul inputs are ``compute_dtype``.
Where the reference asks XLA for an fp32 product of ``compute_dtype``
inputs (``preferred_element_type``), the port upcasts the inputs and
multiplies in fp32: a product of two bf16 values is exact in fp32, so this
is the same arithmetic.  The reference's sharding hints are no-ops without
a mesh and are left out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
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
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or nonparam_ln
    (no parameters)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.kind = cfg.norm
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
                          getattr(self, "bias", None))


def apply_norm(kind: str, x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        y = y * scale.float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
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
    cos = torch.cos(ang)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
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
        g = xc @ self.w_gate.to(c)
        u = xc @ self.w_up.to(c)
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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_positions: torch.Tensor,
                      kv_positions: torch.Tensor, q_chunk: int,
                      kv_chunk: int) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H = KV * G (GQA: query head h
    reads KV head h // G).  q_positions (Sq,) and kv_positions (Skv,) give
    the causal mask and, at decode, the cache-validity mask (cache slots
    with a position past the query's are excluded).  Loops over query
    chunks (outer) and KV chunks (inner); scores, the running max and sum
    and the accumulator are fp32, the probabilities are cast to v's dtype
    for the value product, as in the reference.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qc = _divisor_chunk(q_chunk, Sq)
    kc = _divisor_chunk(kv_chunk, Skv)
    nq, nk = Sq // qc, Skv // kc
    scale = 1.0 / math.sqrt(D)

    qr = q.reshape(B, nq, qc, KV, G, D).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(B, nk, kc, KV, D).permute(1, 0, 3, 2, 4)   # (nk,B,KV,kc,D)
    vr = v.reshape(B, nk, kc, KV, D).permute(1, 0, 3, 2, 4)
    qp = q_positions.reshape(nq, qc)
    kp = kv_positions.reshape(nk, kc)

    outs = []
    for i in range(nq):
        qt = qr[i].float()                      # (B, KV, G, qc, D)
        m = torch.full((B, KV, G, qc), _MASK, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, KV, G, qc, D), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            kt, vt = kr[j], vr[j]               # (B, KV, kc, D)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qt, kt.float()) * scale
            if causal:
                ok = qp[i][:, None] >= kp[j][None, :]
                s = s.masked_fill(~ok, _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vt.dtype).float(), vt.float())
            m = m_new
        outs.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)                     # (nq, B, KV, G, qc, D)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# GQA attention block (with optional KV cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
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

    def qkv(self, x: torch.Tensor, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Projected and rotated q (B, S, H, hd), k and v (B, S, KV, hd)."""
        c = dt(self.cfg)
        xc = x.to(c)
        q = torch.einsum("bsd,dhk->bshk", xc, self.wq.to(c))
        k = torch.einsum("bsd,dhk->bshk", xc, self.wk.to(c))
        v = torch.einsum("bsd,dhk->bshk", xc, self.wv.to(c))
        if self.cfg.qkv_bias:
            q = q + self.bq.to(c)
            k = k + self.bk.to(c)
            v = v + self.bv.to(c)
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
        of its slots, masked by position."""
        cfg = self.cfg
        c = dt(cfg)
        q, k, v = self.qkv(x, positions)
        if cfg.repeat_kv and cache is None and cfg.num_kv_heads < cfg.num_heads:
            G = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)

        new_cache = None
        if cache is not None:
            kc, vc = cache
            at = int(cache_index)
            S = k.shape[1]
            kc[:, at:at + S] = k.to(kc.dtype)
            vc[:, at:at + S] = v.to(vc.dtype)
            new_cache = (kc, vc)
            kv_pos = torch.arange(kc.shape[1], dtype=torch.int32,
                                  device=x.device)
            out = chunked_attention(q, kc, vc, causal=True,
                                    q_positions=positions,
                                    kv_positions=kv_pos,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        else:
            out = chunked_attention(q, k, v, causal=cfg.causal,
                                    q_positions=positions,
                                    kv_positions=positions,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
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
        return self.tok[tokens].to(dt(self.cfg))

    def table(self) -> torch.Tensor:
        return self.unembed if hasattr(self, "unembed") else self.tok


def logits_last(cfg: ModelConfig, embed: Embed, h: torch.Tensor
                ) -> torch.Tensor:
    """Logits for the last position only (decode / prefill output)."""
    return h[:, -1].float() @ embed.table().float().t()


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
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, cs):
        hc = h[:, s0:s0 + cs].to(dt(cfg)).float()
        lc = labels[:, s0:s0 + cs]
        mc = mask[:, s0:s0 + cs].float()
        logits = hc @ W.t()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(lc, min=0).long()[..., None])[..., 0]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
