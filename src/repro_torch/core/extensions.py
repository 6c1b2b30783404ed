"""Beyond-paper extensions (host code, a copy of ``repro.core.extensions``).

1. Transfer-model robustness.  The paper's regeneration time
   max_e f(e)/c(e) assumes *streaming*: every edge transmits concurrently
   and interior nodes re-encode in flight (Section II: "coding operations
   are streamlined with the data transmission").  Real relays may
   store-and-forward (receive a full shard, then re-encode and send);
   ``store_and_forward_time`` evaluates a plan under that pessimistic
   model: t(u) = max over children t(child) + f(u, parent)/c(u, parent).
   Tree schemes lose part of their advantage under S&F while STAR/FR are
   unaffected — a robustness axis the paper does not study.
   ``streaming_time_with_latency`` adds per-hop pipeline-fill latency
   (depth * block_time) to the paper's model.

2. Concurrent multi-failure recovery.  ``plan_multi_failures`` plans r
   simultaneous regenerations with shared providers/links: repairs are
   planned sequentially (most-constrained newcomer first) and each planned
   repair deflates the residual capacity of the links it occupies, so later
   plans route around contended links.  Newcomers never serve as providers
   for one another (their data is not yet regenerated), so each individual
   plan keeps the MDS property by Theorems 3/5.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Sequence, Tuple

from .params import CodeParams, Edge, OverlayNetwork, RepairPlan
from .star import plan_fr
from .ftr import plan_ftr


# ---------------------------------------------------------------------------
# transfer models
# ---------------------------------------------------------------------------

def store_and_forward_time(plan: RepairPlan, net: OverlayNetwork) -> float:
    """Pessimistic relay model: an interior node forwards only after fully
    receiving its children."""
    children: Dict[int, List[int]] = {}
    for u, p in plan.parent.items():
        children.setdefault(p, []).append(u)

    def finish(u: int) -> float:
        child_t = max((finish(ch) for ch in children.get(u, [])), default=0.0)
        f = plan.flows[(u, plan.parent[u])]
        c = net.c(u, plan.parent[u])
        if c <= 0:
            return math.inf
        return child_t + f / c

    return max((finish(r) for r in children.get(0, [])), default=0.0)


def streaming_time_with_latency(plan: RepairPlan, net: OverlayNetwork,
                                block_time: float = 0.0) -> float:
    """Paper model + pipeline-fill latency: depth(u) * block_time added to
    each root-to-leaf chain (negligible for large files, visible for small
    checkpoint shards)."""
    children: Dict[int, List[int]] = {}
    for u, p in plan.parent.items():
        children.setdefault(p, []).append(u)

    def depth(u: int) -> int:
        return 1 + max((depth(ch) for ch in children.get(u, [])), default=0)

    base = 0.0
    for (u, v), f in plan.flows.items():
        c = net.c(u, v)
        base = max(base, f / c if c > 0 else math.inf)
    max_depth = max((depth(r) for r in children.get(0, [])), default=0)
    return base + max_depth * block_time


# ---------------------------------------------------------------------------
# concurrent multi-failure planning
# ---------------------------------------------------------------------------

def plan_multi_failures(params: CodeParams,
                        overlays: Sequence[OverlayNetwork],
                        planner: Callable = plan_ftr,
                        contention: float = 1.0,
                        ) -> List[Tuple[RepairPlan, float]]:
    """Plan len(overlays) simultaneous repairs.

    ``overlays[i]`` is the overlay of the i-th newcomer (node 0) against its
    own d providers; provider index j in different overlays may denote the
    same physical host — the caller encodes that by passing shared
    ``link_ids``-free overlays and a ``contention`` factor in [0, 1]: after
    each planned repair, every overlay link whose *source provider index*
    carried flow is deflated proportionally to its busy fraction.

    Returns [(plan, predicted_time)] in planning order (most-constrained
    first: smallest best direct capacity)."""
    order = sorted(range(len(overlays)),
                   key=lambda i: max(overlays[i].direct_caps()))
    nets = [copy.deepcopy(o) for o in overlays]
    out: List[Tuple[RepairPlan, float]] = [None] * len(overlays)  # type: ignore
    for idx in order:
        net = nets[idx]
        plan = planner(net, params)
        t = plan.time
        out[idx] = (plan, t)
        if t <= 0 or contention <= 0:
            continue
        # deflate residual capacity on links used by this plan for the
        # remaining (concurrent) repairs: a provider busy for fraction
        # busy = (f/c)/t of the window has (1 - contention*busy) left
        for (u, v), f in plan.flows.items():
            c = net.c(u, v)
            if c <= 0:
                continue
            busy = min((f / c) / t, 1.0)
            scale = max(1.0 - contention * busy, 0.05)
            for later in order[order.index(idx) + 1:]:
                ln = nets[later]
                for a in range(ln.num_nodes):
                    # provider u's outgoing links contend in every overlay
                    if u < ln.num_nodes:
                        ln.cap[u][a] *= scale
        # replace: after deflation later plans see reduced capacity
    return out
