"""DeepSeek-V2's multi-head latent attention (MLA, arXiv:2405.04434 §2.1)
without query compression, and its rotary embedding under YaRN, as
DeepSeek-V2-Lite's published modeling code computes them
(``MLAShareConfig``).

Per layer, with H heads: q = x W_Q, each head [q_C; q_R] of
``qk_nope_head_dim`` + ``qk_rope_head_dim``; [c; k_R] = x W_KVa, c of
``kv_lora_rank`` through its own RMSNorm (``kv_norm``); [k_C; v] = c W_KVb,
each head ``qk_nope_head_dim`` + ``v_head_dim``; RoPE on q_R and on the
one k_R, which every head shares; each head's q = [q_C; RoPE(q_R)] and
k = [k_C; RoPE(k_R)], its v narrower; causal attention scaled by
``softmax_scale``; W_O.  The attention runs through
``layers.attention``: on the card the fused kernel's (192, 128) variant,
elsewhere ``chunked_attention`` with the v width and the scale.

RoPE: the published ``DeepseekV2YarnRotaryEmbedding``.  Its frequencies
(:func:`yarn_inv_freq`) blend theta's own (fast dimensions) with theta's
over ``rope_factor`` (slow ones) along a ramp between the correction
dimensions of ``beta_fast`` and ``beta_slow``; its cos and sin carry
mscale(factor, mscale) / mscale(factor, mscale_all_dim), 1 when the two
are equal; its pairs are the interleaved features (2i, 2i + 1), which the
published code moves to the halves before rotating, so the rotated
features come out as [evens; odds] (:func:`rope_pairs`).  The table is
computed once per length and device on the host, in fp32, and the
rotation in fp32 before the cast back.

Device times (``obs.spans.timed``): ``mla``, each block's attention
(forward, remat's recomputation, backward), and ``attn.mla`` each call of
the attention inside it.  Training forwards only: no KV cache.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch import nn

from ..device import DeviceLike
from ..obs import spans
from .config import MLAShareConfig, yarn_mscale
from .layers import apply_norm, attention, dt, param


def _correction_dim(rotations: float, dim: int, base: float,
                    original: int) -> float:
    return dim * math.log(original / (rotations * 2 * math.pi)) \
        / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """(dim / 2,) fp32: YaRN's inverse frequencies (the published
    ``DeepseekV2YarnRotaryEmbedding``): theta's at the dimensions below the
    correction range of ``beta_fast``, theta's over ``factor`` above that
    of ``beta_slow``, a linear ramp between."""
    arange = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** arange)
    inter = 1.0 / (factor * base ** arange)
    low = max(math.floor(_correction_dim(beta_fast, dim, base, original)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, base, original)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


@functools.lru_cache(maxsize=None)
def yarn_table(cfg: MLAShareConfig, length: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (length, 1, rope dim / 2) fp32 on ``device`` for the
    positions 0 .. length - 1, computed on the host once per length."""
    inv = yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta,
                        cfg.rope_factor, cfg.rope_original, cfg.beta_fast,
                        cfg.beta_slow)
    ang = torch.outer(torch.arange(length, dtype=torch.float32), inv)
    m = float(yarn_mscale(cfg.rope_factor, cfg.mscale)
              / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return ((ang.cos() * m)[:, None].to(device),
            (ang.sin() * m)[:, None].to(device))


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, heads, R) rotated by pairs (2i, 2i + 1) at cos, sin (S, 1,
    R / 2), in fp32: [e cos - o sin; o cos + e sin] for the even and odd
    features e, o (the published order), cast back to x's dtype."""
    xf = x.float()
    e, o = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([e * cos - o * sin, o * cos + e * sin],
                     dim=-1).to(x.dtype)


class MLAttention(nn.Module):
    """Multi-head latent attention (see the module docstring): ``wq`` (d,
    H, nope + rope), ``wkv_a`` (d, kv_lora_rank + rope), ``kv_norm``
    (kv_lora_rank,), ``wkv_b`` (kv_lora_rank, H, nope + v), ``wo`` (H, v,
    d)."""

    def __init__(self, cfg: MLAShareConfig, device: DeviceLike = None):
        super().__init__()
        d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
        self.cfg = cfg
        pd = dt(cfg, "param")
        self.wq = param((d, H, cfg.head_dim), pd, device)
        self.wkv_a = param((d, r + cfg.qk_rope_head_dim), pd, device)
        self.kv_norm = param((r,), pd, device)
        self.wkv_b = param((r, H, cfg.qk_nope_head_dim + cfg.v_head_dim), pd,
                           device)
        self.wo = param((H, cfg.v_head_dim, d), pd, device)

    def reset(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        for w, fan in ((self.wq, cfg.d_model), (self.wkv_a, cfg.d_model),
                       (self.wkv_b, cfg.kv_lora_rank),
                       (self.wo, cfg.num_heads * cfg.v_head_dim)):
            w.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)
        self.kv_norm.fill_(1.0)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache=None, cache_index=None):
        """x (B, S, d) -> (y (B, S, d), None); ``positions`` 0 .. S - 1."""
        if cache is not None or cache_index is not None:
            raise NotImplementedError("MLA runs training forwards only")
        return spans.timed("mla", functools.partial(
            self._forward, positions=positions), x), None

    def _forward(self, x: torch.Tensor, positions: torch.Tensor
                 ) -> torch.Tensor:
        cfg = self.cfg
        c = dt(cfg)
        B, S, _ = x.shape
        nope, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
        xc = x.to(c)
        q = torch.einsum("bsd,dhk->bshk", xc, self.wq.to(c))
        kv_a = xc @ self.wkv_a.to(c)
        latent = apply_norm("rmsnorm", kv_a[..., :r], self.kv_norm,
                            eps=cfg.norm_eps)
        kv = torch.einsum("bsr,rhk->bshk", latent, self.wkv_b.to(c))
        cos, sin = yarn_table(cfg, S, x.device)
        at = positions.long()
        cos, sin = cos[at], sin[at]
        q = torch.cat([q[..., :nope], rope_pairs(q[..., nope:], cos, sin)],
                      dim=-1)
        k_rope = rope_pairs(kv_a[..., None, r:], cos, sin)
        k = torch.cat([kv[..., :nope],
                       k_rope.expand(B, S, cfg.num_heads, -1)], dim=-1)
        v = kv[..., nope:]
        out = spans.timed("attn.mla", lambda qq: attention(
            qq, k, v, causal=cfg.causal, q_positions=positions,
            kv_positions=positions, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, cached=False,
            scale=cfg.softmax_scale), q)
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(c))
