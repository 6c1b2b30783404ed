"""Faults planted under the ``train_moe`` loop (``faults.FAULTS``'s are
under the other loops): the train faults of ``faults.py``, and a router
of capacity 1.25 in place of the dropless share, which drops the pairs
past ceil(1.25 T K / E) of an expert (GShard's rule, the capacity of
``models.moe.MoE``)."""
from __future__ import annotations

import contextlib
import math
from unittest import mock

import torch

from perfbench.tools.faults import train_half_batch, train_unchanged
from repro_torch.models.moe import share_plan

CAPACITY_FACTOR = 1.25


def capacity_plan(top_ids: torch.Tensor, first: int, held: int,
                  experts: int, factor: float = CAPACITY_FACTOR):
    """``models.moe.share_plan`` with a capacity: an expert of ``experts``
    takes at most ceil(factor T K / experts) of the T tokens' pairs, in
    token order, and the rest drop (planned as not held, counted in
    ``counts[1]``)."""
    T, K = top_ids.shape
    cap = int(math.ceil(T * K / experts * factor))
    local = top_ids - first
    held_m = (local >= 0) & (local < held)
    key = torch.where(held_m, local, held).reshape(T * K)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    pos = torch.arange(T * K, device=top_ids.device) \
        - torch.searchsorted(ks, ks, side="left")
    keep = torch.empty_like(held_m.reshape(-1))
    keep[order] = pos < cap
    kept = held_m & keep.view(T, K)
    row, valid, pair, offs, counts = share_plan(
        torch.where(kept, top_ids, -1), first, held)
    return (row, valid, pair, offs,
            torch.stack([counts[0], (held_m & ~kept).sum()]))


@contextlib.contextmanager
def capacity_drop():
    """Every ``MoEShare`` layer plans with :func:`capacity_plan` over its
    router's ``router_experts`` in place of ``models.moe.share_plan``."""
    from repro_torch.models import moe
    inner = moe.MoEShare.forward_stats

    def forward_stats(self, x):
        def plan(top_ids, first, held):
            return capacity_plan(top_ids, first, held,
                                 self.cfg.router_experts)
        with mock.patch.object(moe, "share_plan", plan):
            return inner(self, x)
    with mock.patch.object(moe.MoEShare, "forward_stats", forward_stats):
        yield


FAULTS_MOE = {"unchanged": train_unchanged, "half_batch": train_half_batch,
              "capacity": capacity_drop}
