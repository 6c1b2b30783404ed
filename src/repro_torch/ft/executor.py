"""Execute a regeneration plan on real erasure-coded shard data (the
counterpart of ``repro.ft.executor``).

Runs the plan's tree bottom-up: leaf providers encode beta_i random
combinations of their alpha stored blocks, interior providers re-encode
(received ++ own) down to the edge flow, the newcomer stores alpha
combinations of everything received (paper Section II-A / V-A).  Fractional
betas and flows round up (Section III-C).  Every product runs on the
shards' device through the coder's ``RLNC`` (the GF(2^8) kernel on the
card); the coefficients are drawn on the host from ``rng`` in the
reference's order.  Also gives a transfer timeline from the overlay's
bandwidths for reporting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from ..coding import GF8, RLNC, CodedBlocks
from ..core import OverlayNetwork, RepairPlan
from .erasure import EncodedGroup


@dataclasses.dataclass
class ExecutionReport:
    regenerated_host: int
    blocks_moved: float
    predicted_s: float
    per_edge_s: Dict[str, float]


def execute_regeneration(group: EncodedGroup, plan: RepairPlan,
                         overlay: OverlayNetwork, failed_host: int,
                         provider_hosts: List[int],
                         rng: Optional[np.random.Generator] = None,
                         rl: Optional[RLNC] = None) -> ExecutionReport:
    """Regenerates ``failed_host``'s shard in ``group`` (in place).  ``rl``
    runs the products; by default an ``RLNC`` on the shards' device."""
    rng = rng or np.random.default_rng(0)
    if rl is None:
        shard = next(iter(group.shards.values()))
        rl = RLNC(GF8, device=shard.payload.device)
    alpha = int(round(group.params.alpha))
    idmap = {i: h for i, h in enumerate(provider_hosts, start=1)}

    children: Dict[int, List[int]] = {}
    for u, p in plan.parent.items():
        children.setdefault(p, []).append(u)

    def produce(u: int) -> CodedBlocks:
        own_quota = int(math.ceil(plan.betas[u - 1] - 1e-9))
        send_quota = int(math.ceil(plan.flows[(u, plan.parent[u])] - 1e-9))
        own = rl.encode(group.shards[idmap[u]], own_quota, rng)
        recv: Optional[CodedBlocks] = None
        for ch in children.get(u, []):
            part = produce(ch)
            recv = part if recv is None else recv.concat(part)
        if recv is None:
            out = own
        else:
            out = (rl.relay(recv, own, send_quota, rng)
                   if recv.num + own.num > send_quota else recv.concat(own))
        if out.num > send_quota:
            out = CodedBlocks(out.vectors[:send_quota],
                              out.payload[:send_quota])
        return out

    received: Optional[CodedBlocks] = None
    for r in children.get(0, []):
        part = produce(r)
        received = part if received is None else received.concat(part)
    assert received is not None, "plan tree has no edges into the newcomer"
    group.shards[failed_host] = rl.regenerate(received, alpha, rng)

    per_edge = {}
    for (u, v), f in plan.flows.items():
        c = overlay.c(u, v)
        per_edge[f"{idmap.get(u, u)}->{idmap.get(v, 'newcomer')}"] = (
            math.ceil(f) / c if c > 0 else float("inf"))
    return ExecutionReport(regenerated_host=failed_host,
                           blocks_moved=sum(math.ceil(f)
                                            for f in plan.flows.values()),
                           predicted_s=max(per_edge.values()),
                           per_edge_s=per_edge)
