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

``MoE`` mirrors the reference package's capacity-routed layer with
renormalised gates (kimi-k2 and the ``olmoe-1b-7b`` configuration).
:class:`MoEShare` is the published OLMoE layer (``MoEShareConfig``): a
device holds a share of the experts, routes every token over all of
them, and computes its own experts' part of the result, dropless.  Its
dispatch reads no count on the host, so a train step through it can be
captured as a CUDA graph:

  * route: fp32 logits over the router's E outputs, an fp32 softmax, the
    top K by a stable descending sort (ties to the lower index), and the
    gates the top K probabilities as they are;
  * dispatch: the (token, held expert) pairs sorted stably by expert into
    a buffer of T * min(K, held) rows (the worst case, so the shapes are
    static and no pair is dropped); the held experts' row counts and
    offsets stay on the device;
  * experts: three grouped products over exactly the routed rows
    (``kernels.grouped``), the SwiGLU between them;
  * combine: each token's pairs, gate times row, summed over its top K
    in fp32 (the same bits on every run);
  * aux: the router's losses (:func:`router_losses`) and the counts of
    held pairs computed and dropped.

Every index movement is a gather both ways (``_Dispatch``, ``_Combine``:
forward and backward), with no scatter-add, so a step and its graph give
the same bits.  On CUDA tensors the combine, forward and backward, and the
dispatch's backward run on hand kernels that read only the held pairs
(``kernels.moe_gather``, imported at the first such call); on every other
device on their plain versions (:func:`gather_sum_plain`,
:func:`combine_backward_plain`), whose arithmetic the kernels follow.
Spans ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.aux``; counters ``moe.combine.fused``, ``moe.combine.plain``;
device times ``moe`` (the layer) and ``moe.products`` (each grouped
product, forward and backward) (``obs.spans.timed``).

:class:`SharedMoEShare` is DeepSeekMoE's layer (``MLAShareConfig``,
arXiv:2405.04434 §2.2): :class:`MoEShare`'s routed share, plus shared
experts (one SwiGLU of ``shared_experts * d_ff``) run for every token and
added in fp32 (span ``moe.shared``), inside the ``moe`` device time; its
auxiliary loss is the sequence-wise expert balance loss
(:func:`sequence_balance_loss`) and no z-loss.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..distributed.hints import BATCH, batch_local, hint
from ..kernels.grouped import grouped_product
from ..obs import spans
from .config import MLAShareConfig, ModelConfig, MoEShareConfig
from .layers import MLP, dt, param


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


# ---------------------------------------------------------------------------
# a dropless share of OLMoE's experts
# ---------------------------------------------------------------------------

def router_losses(logits: torch.Tensor, probs: torch.Tensor,
                  top_ids: torch.Tensor) -> torch.Tensor:
    """(2,) fp32: OLMoE's load-balancing loss E * sum_e f_e * P_e, with f_e
    the pairs routed to expert e over the tokens (no gradient) and P_e
    the mean probability of e, and the z-loss mean(logsumexp(logits)^2),
    over the tokens of ``logits`` (T, E) and all E experts."""
    T, E = logits.shape
    n = torch.zeros(E, dtype=torch.int64, device=logits.device).scatter_add_(
        0, top_ids.reshape(-1), torch.ones_like(top_ids.reshape(-1)))
    lb = E * (n.float() / T * probs.mean(0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return torch.stack([lb, z])


def sequence_balance_loss(probs: torch.Tensor, top_ids: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """0-d fp32: DeepSeek-V2's sequence-wise expert balance loss (``seq_aux``,
    before its weight): the mean over the ``rows`` sequences of sum_e f_e
    P_e, where f_e = E / (K S) times the choices of expert e among the
    sequence's S tokens (no gradient) and P_e the mean probability of e
    over them; ``probs`` (T, E) and ``top_ids`` (T, K) hold the sequences'
    tokens in order, T = rows * S."""
    T, E = probs.shape
    K = top_ids.shape[1]
    S = T // rows
    n = torch.zeros((rows, E), dtype=torch.int64,
                    device=probs.device).scatter_add_(
        1, top_ids.reshape(rows, S * K),
        torch.ones_like(top_ids.reshape(rows, S * K)))
    f = n.float() / (S * K / E)
    return (f * probs.view(rows, S, E).mean(1)).sum(1).mean()


def share_plan(top_ids: torch.Tensor, first: int, held: int):
    """Where each (token, choice) pair of ``top_ids`` (T, K) goes in the
    held experts' buffer of R = T * min(K, held) rows, the pairs of experts
    ``first .. first + held - 1`` by expert, tokens in order within one
    (a token holds at most min(K, held) of them, so none drops).  Returns

      * ``row`` (T, K): each pair's row (past the held pairs' for the
        others, possibly past R);
      * ``valid`` (T, K): the pair is held;
      * ``pair`` (R,): the flat pair index (token * K + choice) of each
        row;
      * ``offs`` (held,) int32: the held experts' cumulative row ends;
      * ``counts`` (2,) int64: held pairs computed, held pairs dropped
        (0 here; a plan with a capacity reports its drops in the same
        place).

    Every size is fixed by the shapes: nothing is read on the host."""
    T, K = top_ids.shape
    dev = top_ids.device
    local = top_ids - first
    valid = (local >= 0) & (local < held)
    key = torch.where(valid, local, held).reshape(T * K)
    order = torch.argsort(key, stable=True)
    n = torch.zeros(held + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:held]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=dev)
    counts = torch.stack([valid.sum(), torch.zeros((), dtype=torch.int64,
                                                   device=dev)])
    return (rank.view(T, K), valid, order[:T * min(K, held)],
            torch.cumsum(n, 0).to(torch.int32), counts)


def gather_sum_plain(src: torch.Tensor, row: torch.Tensor,
                     valid: torch.Tensor,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, d) fp32: each token's held pairs' rows of ``src`` (R, d), times
    ``scale`` (T, K) fp32 if given, added to zero one pair at a time in k
    order (a row past R read at R - 1; the rows of pairs not held,
    unspecified after a grouped product, masked out).  The plain version
    of ``kernels.moe_gather.gather_sum``, which follows its arithmetic
    operation for operation."""
    at = torch.clamp(row, max=src.shape[0] - 1)
    y = torch.zeros((row.shape[0], src.shape[1]), dtype=torch.float32,
                    device=src.device)
    for k in range(row.shape[1]):
        x = src[at[:, k]].float()
        if scale is not None:
            x = scale[:, k, None] * x
        y = y + torch.where(valid[:, k, None], x, 0.0)
    return y


def combine_backward_plain(gy: torch.Tensor, src: torch.Tensor,
                           gates: torch.Tensor, row: torch.Tensor,
                           valid: torch.Tensor, pair: torch.Tensor):
    """The combine's gradients from ``gy`` (T, d) fp32: (gye (R, d) in
    ``src``'s dtype, row r its pair's gate times its token's ``gy`` and
    zero where the pair is not held; gg (T, K) fp32, each held pair's
    ``gy`` dot its row of ``src``, zero for the others).  The plain version
    of ``kernels.moe_gather.combine_backward``."""
    K = row.shape[1]
    at = torch.clamp(row, max=src.shape[0] - 1)
    gg = torch.where(valid, (gy[:, None] * src[at].float()).sum(-1), 0.0)
    tok = torch.div(pair, K, rounding_mode="floor")
    live = valid.reshape(-1)[pair]
    gye = torch.where(live[:, None], gates.reshape(-1)[pair, None]
                      * gy[tok], 0.0).to(src.dtype)
    return gye, gg


def _gather_sum(src, row, valid, scale=None, out_dtype=torch.float32):
    """:func:`gather_sum_plain`'s function, cast to ``out_dtype``: the hand
    kernel on CUDA tensors, the plain version on every other device."""
    if src.device.type == "cuda":
        from ..kernels import moe_gather
        return moe_gather.gather_sum(src, row, valid, scale, out_dtype)
    return gather_sum_plain(src, row, valid, scale).to(out_dtype)


class _Dispatch(torch.autograd.Function):
    """x (T, d) -> the buffer's rows (R, d), row r of token pair[r] // K.
    The backward gathers each token's K rows back and sums the valid ones
    over K in fp32, in k order (:func:`_gather_sum`: a gather and a sum, no
    scatter-add, the same bits on every run)."""

    @staticmethod
    def forward(ctx, x, pair, row, valid):
        K = row.shape[1]
        ctx.save_for_backward(row, valid)
        return x.index_select(0, torch.div(pair, K, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, g):
        row, valid = ctx.saved_tensors
        return (_gather_sum(g.contiguous(), row, valid, out_dtype=g.dtype),
                None, None, None)


class _Combine(torch.autograd.Function):
    """ye (R, d), gates (T, K) fp32 -> y (T, d) fp32: each token's valid
    pairs, gate times its row, summed over K in fp32 in k order
    (:func:`_gather_sum`: the same bits on every run).  Rows of no valid
    pair (unspecified after a grouped product) are masked out, forward and
    backward; each row's gradient is its token's, times its gate
    (:func:`combine_backward_plain`, or the hand kernel on CUDA tensors).
    Counters ``moe.combine.fused`` and ``moe.combine.plain``: a call of
    each route, forward or backward."""

    @staticmethod
    def forward(ctx, ye, gates, row, valid, pair):
        ctx.save_for_backward(ye, gates, row, valid, pair)
        spans.count("moe.combine.fused" if ye.device.type == "cuda"
                    else "moe.combine.plain")
        return _gather_sum(ye, row, valid, gates)

    @staticmethod
    def backward(ctx, gy):
        ye, gates, row, valid, pair = ctx.saved_tensors
        if ye.device.type == "cuda":
            from ..kernels import moe_gather
            spans.count("moe.combine.fused")
            gye, gg = moe_gather.combine_backward(gy.contiguous(), ye, gates,
                                                  row, valid, pair)
        else:
            spans.count("moe.combine.plain")
            gye, gg = combine_backward_plain(gy, ye, gates, row, valid, pair)
        return gye, gg, None, None, None


class MoEShare(nn.Module):
    """The experts ``expert_offset .. expert_offset + num_experts - 1`` of
    a dropless MoE layer with OLMoE's gating (``MoEShareConfig``): the
    router keeps all ``router_experts`` outputs, the experts here compute
    their part of the result, and a token with none of its top K here
    gets zero.  ``routes``, when set to a list, receives each call's
    held choices, (T, K) expert ids with -1 for the others (the
    benchmark's judge reads them)."""

    def __init__(self, cfg: MoEShareConfig, device: DeviceLike = None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.cfg = cfg
        pd = dt(cfg, "param")
        self.router = param((d, cfg.router_experts), torch.float32, device)
        self.we_gate = param((E, d, f), pd, device)
        self.we_up = param((E, d, f), pd, device)
        self.we_down = param((E, f, d), pd, device)
        self.routes = None

    reset = MoE.reset

    def experts(self, xs: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """xs (R, d) -> (R, d): each held expert's SwiGLU over its rows,
        each grouped product's device time kept as ``moe.products``."""
        c = dt(self.cfg)

        def product(a, w):
            return spans.timed("moe.products", functools.partial(
                grouped_product, b=w.to(c), offs=offs), a)
        g = product(xs, self.we_gate)
        u = product(xs, self.we_up)
        h = F.silu(g.float()).to(c) * u
        return product(h, self.we_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_stats(x)[0]

    def forward_stats(self, x: torch.Tensor):
        """x (B, S, d) -> (y (B, S, d) in x's dtype, the router's losses
        (2,) fp32 (:meth:`aux_losses`), the counts (2,) int64 of held
        pairs computed and dropped)."""
        return spans.timed("moe", self._layer, x)

    def aux_losses(self, logits: torch.Tensor, probs: torch.Tensor,
                   top_ids: torch.Tensor, rows: int) -> torch.Tensor:
        """(2,) fp32 auxiliary losses of the ``rows`` sequences' tokens:
        OLMoE's (:func:`router_losses`)."""
        return router_losses(logits, probs, top_ids)

    def add_shared(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The layer's fp32 output (T, d) from the routed share's ``y`` and
        the layer's input ``x`` (T, d): ``y`` (no shared experts)."""
        return y

    def _layer(self, x: torch.Tensor):
        cfg = self.cfg
        B, S, d = x.shape
        T, K = B * S, cfg.experts_per_token
        xf = x.reshape(T, d)
        with spans.span("moe.route"):
            logits = xf.float() @ self.router
            probs = torch.softmax(logits, dim=-1)
            top_ids = torch.sort(logits, dim=-1, descending=True,
                                 stable=True).indices[:, :K]
            gates = torch.gather(probs, 1, top_ids)
        with spans.span("moe.aux"):
            aux = self.aux_losses(logits, probs, top_ids, B)
        with spans.span("moe.dispatch"):
            row, valid, pair, offs, counts = share_plan(
                top_ids, cfg.expert_offset, cfg.num_experts)
            if self.routes is not None:
                local = top_ids - cfg.expert_offset
                self.routes.append(torch.where(
                    (local >= 0) & (local < cfg.num_experts), top_ids, -1))
            xs = _Dispatch.apply(xf.to(dt(cfg)), pair, row, valid)
        with spans.span("moe.experts"):
            ye = self.experts(xs, offs)
        with spans.span("moe.combine"):
            y = _Combine.apply(ye, gates, row, valid, pair)
        y = self.add_shared(xf, y)
        return y.view(B, S, d).to(x.dtype), aux, counts


class SharedMoEShare(MoEShare):
    """DeepSeekMoE's layer (``MLAShareConfig``): :class:`MoEShare`'s routed
    share of the experts, plus ``shared`` (an ``MLP`` of width
    ``shared_experts * d_ff``, the shared experts as one SwiGLU) over every
    token, added to the routed part in fp32; the auxiliary losses are
    (:func:`sequence_balance_loss`, 0)."""

    def __init__(self, cfg: MLAShareConfig, device: DeviceLike = None):
        super().__init__(cfg, device)
        self.shared = MLP(cfg, device, d_ff=cfg.shared_experts * cfg.d_ff)

    def aux_losses(self, logits, probs, top_ids, rows):
        balance = sequence_balance_loss(probs, top_ids, rows)
        return torch.stack([balance, torch.zeros_like(balance)])

    def add_shared(self, x, y):
        with spans.span("moe.shared"):
            return y + self.shared(x).float()
