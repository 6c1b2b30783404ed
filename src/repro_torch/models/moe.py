"""Capacity-routed top-k Mixture-of-Experts block (kimi-k2, olmoe): the
counterpart of ``repro.models.moe``.

Dispatch is per batch row: every token picks its top-K experts, the
(token, expert) pairs are sorted by expert (stably, so tokens keep their
order within an expert), and each pair takes the next slot of its expert's
buffer.  A row's expert holds ceil(S*K/E * capacity_factor) slots; pairs
beyond that drop (GShard semantics).  The reference writes a dropped pair
to the out-of-range slot E*cap with ``mode="drop"``; torch has no drop
mode, so the port's buffer has one extra dump row at E*cap that takes the
dropped pairs and is cut off before the experts run.

With DTensor inputs (``distributed``), the routing and the dispatch
scatter, and the combine, run on each device's rows (``batch_local``:
``sort``, ``searchsorted``, the indexed scatter and ``scatter_add_`` are
row-local, and not all of them have DTensor sharding rules); the router
and the experts run through DTensor's sharding propagation, the experts
sharded over (pod, model) between the reference's two all-to-all hints.

Ties in the router: ``jax.lax.top_k`` puts the lower expert index first
among equal logits.  ``torch.topk`` does not promise an order, so the port
sorts the logits stably in descending order and takes the first K, which
keeps the lower index first as the reference does.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..distributed.hints import BATCH, batch_local, hint
from .config import ModelConfig
from .layers import dt, param


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.cfg = cfg
        pd = dt(cfg, "param")
        self.router = param((d, E), torch.float32, device)
        self.we_gate = param((E, d, f), pd, device)
        self.we_up = param((E, d, f), pd, device)
        self.we_down = param((E, f, d), pd, device)

    def reset(self, gen: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        self.router.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.we_gate.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.we_up.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.we_down.normal_(0.0, 1.0 / math.sqrt(f), generator=gen)

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """xe: (E, C, d) -> (E, C, d), the batched expert SwiGLU."""
        c = dt(self.cfg)
        g = torch.bmm(xe, self.we_gate.to(c))
        u = torch.bmm(xe, self.we_up.to(c))
        h = F.silu(g.float()).to(c) * u
        return torch.bmm(h, self.we_down.to(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, d) -> (B, S, d)."""
        cfg = self.cfg
        B, S, d = x.shape
        E, K = cfg.num_experts, cfg.experts_per_token
        cap = int(math.ceil(S * K / E * cfg.moe_capacity_factor))
        logits = x.float() @ self.router                       # (B, S, E)
        xd, route = batch_local(
            functools.partial(_dispatch, K=K, cap=cap, dtype=dt(cfg)),
            x, logits)
        # batch-sharded -> expert-sharded on the same tensor (no transpose
        # in between): the expert-parallel all-to-all
        xd = hint(xd, None, ("pod", "model"), None, None)
        xd = xd.permute(1, 0, 2, 3).reshape(E, B * cap, d)
        ye = self.experts(xd)
        ye = ye.reshape(E, B, cap, d).permute(1, 0, 2, 3)
        ye = hint(ye, BATCH, None, None, None)      # all-to-all back
        return batch_local(functools.partial(_combine, S=S), ye,
                           *route).to(x.dtype)


def _dispatch(x: torch.Tensor, logits: torch.Tensor, K: int, cap: int,
              dtype: torch.dtype):
    """Routing and the row-local scatter of each row's tokens into its
    experts' buffers: (xd (B, E, cap, d), (slot, keep, t_sorted,
    g_sorted))."""
    B, S, d = x.shape
    E = logits.shape[-1]
    top_vals, top_ids = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_ids = top_vals[..., :K], top_ids[..., :K]
    gates = torch.softmax(top_vals, dim=-1)
    e_flat = top_ids.reshape(B, S * K)
    t_flat = torch.arange(S, device=x.device).repeat_interleave(K) \
        .expand(B, S * K)
    g_flat = gates.reshape(B, S * K)

    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    t_sorted = torch.gather(t_flat, 1, order)
    g_sorted = torch.gather(g_flat, 1, order)
    start = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(S * K, device=x.device)[None] - start
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos,
                       torch.full_like(pos, E * cap))           # the dump row

    gathered = torch.gather(x.to(dtype), 1,
                            t_sorted[..., None].expand(-1, -1, d))
    buf = torch.zeros((B, E * cap + 1, d), dtype=dtype, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf[rows, slot] = gathered
    xd = buf[:, :E * cap].reshape(B, E, cap, d)
    return xd, (slot, keep, t_sorted, g_sorted)


def _combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             t_sorted: torch.Tensor, g_sorted: torch.Tensor,
             S: int) -> torch.Tensor:
    """The weighted scatter-add of each row's expert outputs (B, E, cap,
    d) back to its tokens: (B, S, d) in fp32."""
    B, E, cap, d = ye.shape
    ye = ye.reshape(B, E * cap, d)
    contrib = torch.gather(
        ye, 1, torch.clamp(slot, max=E * cap - 1)[..., None].expand(-1, -1, d))
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros_like(contrib)).float()
    contrib = contrib * g_sorted[..., None]
    y = torch.zeros((B, S, d), dtype=torch.float32, device=ye.device)
    y.scatter_add_(1, t_sorted[..., None].expand(-1, -1, d), contrib)
    return y
