# Frozen plain copy of src/repro_torch/core/tree.py at commit 945b8950ea47
# (itself the reference package's scalar planner, repro/core/tree.py).
# The benchmark's yardstick: later changes to the program do not move it.
"""Tree-structured regeneration with constant repair traffic (TR, Section IV).

Theorem 3: on a regeneration tree T rooted at the newcomer, the minimum
MDS-preserving flow on edge (u, v) is  min(m_u * beta, alpha)  where m_u is
the subtree size of u and beta the conventional uniform traffic.

Building the optimal tree (ORT) is NP-hard (Theorem 4, reduction from
VERTEX-COVER); Algorithm 1 is the paper's Prim-like O(|V|^3) heuristic:
grow the tree from the newcomer, each step attaching the (provider,
position) pair that minimizes the regeneration time of the partial tree.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from .params import CodeParams, OverlayNetwork, RepairPlan, tree_flows


def tree_time_uniform(parent: Dict[int, int], net: OverlayNetwork,
                      params: CodeParams) -> float:
    """Regeneration time of a tree under uniform per-provider traffic beta
    with Theorem-3 flows."""
    betas = [params.beta] * params.d
    flows = tree_flows(parent, betas, params.alpha)
    t = 0.0
    for (u, v), f in flows.items():
        c = net.c(u, v)
        if c <= 0:
            return math.inf
        t = max(t, f / c)
    return t


def plan_tr(net: OverlayNetwork, params: CodeParams) -> RepairPlan:
    """Algorithm 1: greedy tree construction."""
    d = params.d
    parent: Dict[int, int] = {}
    in_tree = {0}
    remaining = set(range(1, d + 1))

    while remaining:
        # Tie-break: among equal partial times prefer the candidate whose new
        # edge (v -> u) has the larger capacity c(v, u) — capacities are
        # directed, so the child->parent direction matters.  The key is stored
        # alongside the winner rather than recomputed from the stored (v, u)
        # at every comparison, so the comparison provably uses the same
        # quantity that was minimized.
        best: Optional[Tuple[int, int]] = None
        best_key: Optional[Tuple[float, float]] = None
        for v in sorted(remaining):
            for u in sorted(in_tree):
                cand = dict(parent)
                cand[v] = u
                t = _partial_time(cand, net, params)
                key = (t, -net.c(v, u))
                if best_key is None or key < best_key:
                    best, best_key = (v, u), key
        assert best is not None
        v, u = best
        parent[v] = u
        in_tree.add(v)
        remaining.discard(v)

    betas = [params.beta] * d
    flows = tree_flows(parent, betas, params.alpha)
    time = tree_time_uniform(parent, net, params)
    return RepairPlan("tr", params, parent, betas, flows, time)


def _partial_time(parent: Dict[int, int], net: OverlayNetwork,
                  params: CodeParams) -> float:
    """Time of a partial tree: Theorem-3 flows over the attached providers
    only (each attached provider contributes beta)."""
    betas = [0.0] * params.d
    for u in parent:
        betas[u - 1] = params.beta
    flows = tree_flows(parent, betas, params.alpha)
    t = 0.0
    for (u, v), f in flows.items():
        c = net.c(u, v)
        if c <= 0:
            return math.inf
        t = max(t, f / c)
    return t
