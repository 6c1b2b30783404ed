"""Capacity-routed top-k Mixture-of-Experts block (kimi-k2, olmoe): the
counterpart of ``repro.models.moe``.

Dispatch is per batch row: every token picks its top-K experts, the
(token, expert) pairs are sorted by expert (stably, so tokens keep their
order within an expert), and each pair takes the next slot of its expert's
buffer.  A row's expert holds ceil(S*K/E * capacity_factor) slots; pairs
beyond that drop (GShard semantics).  The reference writes a dropped pair
to the out-of-range slot E*cap with ``mode="drop"``; torch has no drop
mode, so the port's buffer has one extra dump row at E*cap that takes the
dropped pairs and is cut off before the experts run.  The combine adds
each token's contributions in a fixed order (see ``_combine``), so a step
gives the same bits on every run, on the card as on the CPU.

With DTensor inputs (``distributed``), the routing and the dispatch
scatter, and the combine, run on each device's rows (``batch_local``:
``sort``, ``searchsorted``, the indexed scatter and the gathers are
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
    experts' buffers: (xd (B, E, cap, d), (slot, keep, gate)), the last
    three (B, S*K) in :func:`_combine`'s order."""
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
    # the pairs back in token order, each token's K in its experts' id
    # order: the order in which _combine adds a token's contributions
    by_token = torch.argsort(t_sorted * E + e_sorted, dim=1)
    return xd, tuple(torch.gather(a, 1, by_token)
                     for a in (slot, keep, g_sorted))


def _combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gate: torch.Tensor, S: int) -> torch.Tensor:
    """The weighted sum of each row's expert outputs (B, E, cap, d) back
    into its tokens: (B, S, d) in fp32.  ``slot``, ``keep`` and ``gate``
    ((B, S*K)) hold each token's K pairs together, in its experts' id
    order, and a token's contributions are added to zero one at a time in
    that order: the order of a sequential scatter-add over the
    expert-sorted pairs (the CPU's ``scatter_add_``, bit for bit).  CUDA's
    ``scatter_add_`` adds them with atomics, in an order, and so with a
    rounding, that varies from run to run."""
    B, E, cap, d = ye.shape
    K = slot.shape[1] // S
    contrib = torch.gather(
        ye.reshape(B, E * cap, d), 1,
        torch.clamp(slot, max=E * cap - 1)[..., None].expand(-1, -1, d))
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros_like(contrib)).float()
    contrib = (contrib * gate[..., None]).view(B, S, K, d)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=ye.device)
    for k in range(K):
        y += contrib[:, :, k]
    return y
