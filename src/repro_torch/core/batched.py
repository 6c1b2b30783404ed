"""Batch containers of the planning tier: :class:`BatchPlanResult`,
``caps_tensor`` and ``plans_from_batch`` (the counterparts of the ones in
``repro.core.batched``).

A batch result holds torch tensors on the device that planned the batch:
float64 ``times``, ``traffic``, ``betas`` and ``lower_bounds``, int64
``parents``.  The planners themselves are in :mod:`.torch_engine`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import spans
from .params import CodeParams, OverlayNetwork, RepairPlan, tree_flows

__all__ = ["BatchPlanResult", "caps_tensor", "plans_from_batch",
           "plans_from_batches"]


@dataclasses.dataclass
class BatchPlanResult:
    """Vectorized counterpart of a list of :class:`RepairPlan`.

    ``parents[b, u]`` is the tree parent of provider u (parents[b, 0] = 0);
    ``betas[b, i]`` the traffic generated by provider i+1; ``times`` /
    ``traffic`` match ``RepairPlan.time`` / ``RepairPlan.total_traffic``.

    ``engine`` says which planner produced the batch: ``"batched"`` for the
    tensor programs of :mod:`.torch_engine`, ``"scalar"`` when
    :func:`~repro_torch.core.api.plan_many` ran the per-network scalar
    planner, in which case ``plans`` carries the scalar plans (rctree's
    flows cannot be re-derived from (parents, betas), so
    :func:`plans_from_batch` returns them verbatim), and ``"mixed"`` for a
    ragged batch whose buckets took different engines.
    """

    scheme: str
    times: torch.Tensor                 # (B,) float64
    traffic: torch.Tensor               # (B,) float64
    betas: torch.Tensor                 # (B, d) float64
    parents: torch.Tensor               # (B, d+1) int64
    lower_bounds: Optional[torch.Tensor] = None     # (B,) float64
    engine: str = "batched"
    plans: Optional[list] = None


def caps_tensor(nets: Sequence[OverlayNetwork],
                device: DeviceLike = None) -> torch.Tensor:
    """Stack overlay capacity matrices into a float64 (B, d+1, d+1) tensor on
    ``device`` (the card unless ``device="cpu"``), in one copy."""
    caps = np.stack([np.asarray(n.cap, dtype=np.float64) for n in nets])
    return torch.from_numpy(caps).to(resolve_device(device))


def star_parents(B: int, d: int, device: torch.device) -> torch.Tensor:
    """Parents of B star trees: every provider sends to the newcomer."""
    return torch.zeros((B, d + 1), dtype=torch.long, device=device)


def plans_from_batch(res: BatchPlanResult,
                     params: CodeParams) -> List[RepairPlan]:
    """One scalar :class:`RepairPlan` per batch lane.

    The flows are re-derived from (parents, betas) by ``tree_flows``, the
    map every scalar planner uses, so ``RepairPlan.validate`` and the plan
    replay see the structure the batch planned.  Infeasible lanes keep
    their inf time.  The batch crosses to the host in one copy.  A batch
    that carries its scalar plans (``res.plans``) returns them verbatim.
    """
    [plans] = plans_from_batches([res], params)
    return plans


def plans_from_batches(results: Sequence[BatchPlanResult],
                       params: CodeParams) -> List[List[RepairPlan]]:
    """:func:`plans_from_batch` of several batches planned for one
    ``params``, with all of their device tensors crossing to the host in
    one copy (a policy that races schemes reads its slate once)."""
    blocks = []
    for res in results:
        if res.plans is not None:
            continue
        lbs = (res.lower_bounds if res.lower_bounds is not None
               else torch.full_like(res.times, float("nan")))
        blocks.append(torch.cat([res.times[:, None], res.betas,
                                 res.parents.to(torch.float64),
                                 lbs[:, None]], dim=1))
    rows = []
    if blocks:
        spans.count("plan.reads.unpack")
        rows = torch.cat([b.to(blocks[0].device) for b in blocks]
                         ).cpu().tolist()
    out: List[List[RepairPlan]] = []
    at = 0
    for res in results:
        if res.plans is not None:
            out.append(list(res.plans))
            continue
        d = res.betas.shape[1]
        B = res.times.shape[0]
        plans = []
        for row in rows[at:at + B]:
            betas = row[1:1 + d]
            parent = {u: int(row[1 + d + u]) for u in range(1, d + 1)}
            lb = row[2 + 2 * d] if res.lower_bounds is not None else None
            plans.append(RepairPlan(res.scheme, params, parent, betas,
                                    tree_flows(parent, betas, params.alpha),
                                    row[0], lower_bound=lb))
        at += B
        out.append(plans)
    return out
