"""Brute-force Optimal Regeneration Tree (exact, exponential; host code, a
copy of ``repro.core.ort``).

The ORT problem is NP-hard (Theorem 4); for small d we enumerate every
rooted spanning tree of the complete overlay (Cayley: (d+1)^(d-1) trees) to
obtain the exact optimum, used to measure the optimality gap of the TR and
FTR heuristics in tests and benchmarks.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, Optional, Tuple

from .params import CodeParams, OverlayNetwork, RepairPlan, tree_flows
from .regions import FeasibleRegion, heuristic_region, msr_region
from .tree import tree_time_uniform
from .ftr import eval_tree


def iter_rooted_trees(d: int) -> Iterator[Dict[int, int]]:
    """All parent maps over providers 1..d rooted at 0 (no cycles)."""
    nodes = list(range(1, d + 1))
    for choice in itertools.product(range(0, d + 1), repeat=d):
        parent = {}
        ok = True
        for u, p in zip(nodes, choice):
            if p == u:
                ok = False
                break
            parent[u] = p
        if not ok:
            continue
        # reject cycles (every node must reach 0)
        good = True
        for u in nodes:
            seen, x = set(), u
            while x != 0:
                if x in seen:
                    good = False
                    break
                seen.add(x)
                x = parent[x]
            if not good:
                break
        if good:
            yield parent


def plan_ort_uniform(net: OverlayNetwork, params: CodeParams) -> RepairPlan:
    """Exact TR optimum: best tree under uniform traffic (Theorem-3 flows)."""
    best_parent, best_t = None, math.inf
    for parent in iter_rooted_trees(params.d):
        t = tree_time_uniform(parent, net, params)
        if t < best_t:
            best_parent, best_t = dict(parent), t
    assert best_parent is not None
    betas = [params.beta] * params.d
    flows = tree_flows(best_parent, betas, params.alpha)
    return RepairPlan("ort", params, best_parent, betas, flows, best_t)


def plan_ort_flexible(net: OverlayNetwork, params: CodeParams,
                      region: Optional[FeasibleRegion] = None) -> RepairPlan:
    """Exact FTR optimum: best tree under flexible traffic (LP per tree)."""
    if region is None:
        region = msr_region(params) if params.is_msr else heuristic_region(params)
    best_parent, best_t = None, math.inf
    for parent in iter_rooted_trees(params.d):
        t, _ = eval_tree(parent, net, params, region, iters=30)
        if t < best_t:
            best_parent, best_t = dict(parent), t
    assert best_parent is not None
    t_star, betas = eval_tree(best_parent, net, params, region, iters=50)
    assert betas is not None
    flows = tree_flows(best_parent, betas, params.alpha)
    time = 0.0
    for (u, v), f in flows.items():
        c = net.c(u, v)
        time = max(time, f / c if c > 0 else math.inf)
    return RepairPlan("ort_flex", params, best_parent, betas, flows, time,
                      lower_bound=t_star)
