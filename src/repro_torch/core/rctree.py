"""RCTREE baseline (Li et al. [7]) — the prior tree scheme that LOSES the
MDS property (paper Appendix A).

RCTREE builds a maximum-bottleneck regeneration tree with the constraint
that the newcomer keeps degree >= d-k+1, and transmits a *fixed* beta on
every edge (interior nodes combine their own alpha blocks with received
blocks into just beta coded blocks).  Because interior edges carry beta
instead of min(m_u * beta, alpha), downstream information is destroyed and
some k-subsets can no longer rebuild the file (Fig. 9 / Fig. 10).
"""
from __future__ import annotations

import math
from typing import Dict

from .params import CodeParams, OverlayNetwork, RepairPlan


def plan_rctree(net: OverlayNetwork, params: CodeParams) -> RepairPlan:
    d = params.d
    b = params.beta
    # Prim-style maximum-bottleneck spanning tree from the newcomer.
    parent: Dict[int, int] = {}
    in_tree = [0]
    remaining = set(range(1, d + 1))
    while remaining:
        best_u, best_v, best_c = None, None, -1.0
        for u in remaining:
            for v in in_tree:
                if net.c(u, v) > best_c:
                    best_u, best_v, best_c = u, v, net.c(u, v)
        parent[best_u] = best_v
        in_tree.append(best_u)
        remaining.discard(best_u)

    # enforce newcomer degree >= d-k+1 ([7], Algorithm 1): re-attach the
    # cheapest interior children directly to the root until satisfied.
    def root_degree() -> int:
        return sum(1 for p in parent.values() if p == 0)

    while root_degree() < params.d - params.k + 1:
        cands = [u for u in parent if parent[u] != 0]
        u = max(cands, key=lambda u: net.c(u, 0))
        parent[u] = 0

    flows = {(u, p): b for u, p in parent.items()}  # fixed beta per edge!
    t = 0.0
    for (u, p), f in flows.items():
        c = net.c(u, p)
        t = max(t, f / c if c > 0 else math.inf)
    betas = [b] * d
    plan = RepairPlan("rctree", params, parent, betas, flows, t)
    return plan
