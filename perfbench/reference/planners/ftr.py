# Frozen plain copy of src/repro_torch/core/ftr.py at commit 945b8950ea47
# (itself the reference package's scalar planner, repro/core/ftr.py).
# The benchmark's yardstick: later changes to the program do not move it.
"""Flexible Tree-structured Regeneration (FTR, paper Section V).

Combines the tree topology (Section IV) with non-uniform per-provider
traffic (Section III).  Theorem 5 gives the sufficient MDS condition — the
same sigma_j thresholds as the star heuristic region — and for a *given*
tree the optimal time is found exactly (bisection + LP oracle,
``lp.tree_optimal_time``; cf. problem (5)-(10)).

Tree search follows Algorithm 2: for each i = 0..d, grow a max-capacity
core subtree of i links from the newcomer, attach the remaining providers
to their best position in the core, then locally improve with pivot moves
(re-attach one subtree) while the exact per-tree objective improves.  Two
extra candidate trees are evaluated — the FR star (i = 0, which Algorithm 2
already contains) and the TR tree — so FTR is never worse than FR or TR
(the paper's "promised by design" dominance, Section VI-A, made explicit).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .params import CodeParams, Edge, OverlayNetwork, RepairPlan, tree_flows
from .regions import FeasibleRegion, heuristic_region, msr_region
from . import lp
from .tree import plan_tr

# Search hyper-parameters: the values of the reference planner
# (``repro.core.ftr``), which this module copies decision for decision.
EVAL_ITERS = 40        # fresh-tree bisection depth (eval_tree)
REFINE_ITERS = 28      # incumbent-bounded bisection depth (_refine)
FINAL_ITERS = 50       # high-precision solve on the winning tree
LOCAL_SEARCH_ROUNDS = 3
LOCAL_SEARCH_ALTS = 8  # alternative parents probed per pivot node
PROBE_SLACK = 1 - 1e-7  # pivot must beat the incumbent by this factor


def _edge_caps(parent: Dict[int, int], net: OverlayNetwork) -> Dict[Edge, float]:
    return {(u, p): net.c(u, p) for u, p in parent.items()}


def eval_tree(parent: Dict[int, int], net: OverlayNetwork, params: CodeParams,
              region: FeasibleRegion, iters: int = EVAL_ITERS,
              minimize_traffic: bool = False, witness: str = "exact",
              ) -> Tuple[float, Optional[List[float]]]:
    return lp.tree_optimal_time(parent, _edge_caps(parent, net), region,
                                params.alpha, iters=iters,
                                minimize_traffic=minimize_traffic,
                                witness=witness)


def _grow_core(net: OverlayNetwork, i: int, d: int) -> List[int]:
    """Lines 3-8 of Algorithm 2: greedily add the largest-capacity cut link."""
    core = [0]
    for _ in range(i):
        best_u, best_c, best_v = None, -1.0, None
        for u in range(1, d + 1):
            if u in core:
                continue
            for v in core:
                if net.c(u, v) > best_c:
                    best_u, best_c, best_v = u, net.c(u, v), v
        if best_u is None:
            break
        core.append(best_u)
    return core


def _initial_tree(net: OverlayNetwork, core: List[int], d: int) -> Dict[int, int]:
    """Core subtree edges (each core node to its best earlier core node) plus
    lines 10-14: attach every remaining provider to its best core position."""
    parent: Dict[int, int] = {}
    placed = [0]
    for u in core[1:]:
        v = max(placed, key=lambda v: net.c(u, v))
        parent[u] = v
        placed.append(u)
    for u in range(1, d + 1):
        if u in core:
            continue
        v = max(core, key=lambda v: net.c(u, v))
        parent[u] = v
    return parent


def _descendants(parent: Dict[int, int], u: int, d: int) -> set:
    desc = set()
    for w in range(1, d + 1):
        x = w
        while x != 0:
            if x == u:
                desc.add(w)
                break
            x = parent[x]
    return desc


def _feasible_at(t: float, parent: Dict[int, int], net: OverlayNetwork,
                 params: CodeParams, region: FeasibleRegion) -> bool:
    return lp.tree_feasible_at_time(t, parent, _edge_caps(parent, net),
                                    region, params.alpha) is not None


def _refine(parent: Dict[int, int], net: OverlayNetwork, params: CodeParams,
            region: FeasibleRegion, t_ub: float,
            iters: int = REFINE_ITERS) -> float:
    """Bisect the optimal time of ``parent`` knowing it is feasible at t_ub."""
    lo, hi = 0.0, t_ub
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if _feasible_at(mid, parent, net, params, region):
            hi = mid
        else:
            lo = mid
    return hi


def _local_search(parent: Dict[int, int], net: OverlayNetwork,
                  params: CodeParams, region: FeasibleRegion, t_cur: float,
                  max_rounds: int = LOCAL_SEARCH_ROUNDS,
                  max_alts: int = LOCAL_SEARCH_ALTS,
                  ) -> Tuple[Dict[int, int], float]:
    """Pivot search with incremental evaluation: each candidate pivot is
    first probed with a single feasibility check at the incumbent time;
    bisection runs only on acceptance.  This keeps the oracle-call count
    O(pivots + log(1/eps) * improvements) rather than O(pivots * log)."""
    d = params.d
    for _ in range(max_rounds):
        improved = False
        for u in range(1, d + 1):
            desc = _descendants(parent, u, d)
            cur_p = parent[u]
            # try alternative parents in decreasing link-capacity order
            alts = sorted((v for v in range(0, d + 1)
                           if v != u and v != cur_p and v not in desc
                           and net.c(u, v) > 0),
                          key=lambda v: -net.c(u, v))[:max_alts]
            for v in alts:
                parent[u] = v
                if _feasible_at(t_cur * PROBE_SLACK, parent, net, params, region):
                    t_cur = _refine(parent, net, params, region, t_cur)
                    cur_p = v
                    improved = True
                else:
                    parent[u] = cur_p
        if not improved:
            break
    return parent, t_cur


def plan_ftr(net: OverlayNetwork, params: CodeParams,
             region: FeasibleRegion | None = None,
             core_sizes: Optional[List[int]] = None,
             local_search: bool = True,
             witness: str = "exact") -> RepairPlan:
    """Algorithm 2 over all core sizes i, plus the TR tree as a candidate.

    ``witness`` picks the final traffic-minimal witness engine: the exact
    level-cut oracle (default) or the scipy LP (``witness="lp"``)."""
    if witness not in ("exact", "lp"):   # eager: fail before the tree search
        raise ValueError(f"unknown witness engine {witness!r}")
    d = params.d
    if region is None:
        region = msr_region(params) if params.is_msr else heuristic_region(params)

    candidates: List[Dict[int, int]] = []
    sizes = core_sizes if core_sizes is not None else list(range(0, d + 1))
    for i in sizes:
        core = _grow_core(net, i, d)
        candidates.append(_initial_tree(net, core, d))
    candidates.append(dict(plan_tr(net, params).parent))  # dominance over TR

    # evaluate every candidate tree, then local-search the few best
    scored: List[Tuple[float, Dict[int, int]]] = []
    seen = set()
    incumbent = math.inf
    for cand in candidates:
        key = tuple(sorted(cand.items()))
        if key in seen:
            continue
        seen.add(key)
        if incumbent is math.inf:
            t, _ = eval_tree(cand, net, params, region)
        elif _feasible_at(incumbent, cand, net, params, region):
            t = _refine(cand, net, params, region, incumbent)
        else:  # exact: cannot beat the incumbent time
            t = math.inf
        incumbent = min(incumbent, t)
        scored.append((t, cand))
    scored.sort(key=lambda x: x[0])

    best_t, best_parent = scored[0]
    if local_search:
        for t, cand in scored[:3]:
            if t is math.inf:
                continue
            cand, t = _local_search(dict(cand), net, params, region, t)
            if t < best_t:
                best_parent, best_t = dict(cand), t

    assert best_parent is not None
    # final high-precision solve on the winning tree, then the
    # traffic-minimal witness at the optimal time
    t_star, betas = eval_tree(best_parent, net, params, region,
                              iters=FINAL_ITERS, minimize_traffic=True,
                              witness=witness)
    if betas is None:  # pragma: no cover - winning tree is feasible by search
        raise RuntimeError("FTR: winning tree lost feasibility at final solve")
    flows = tree_flows(best_parent, betas, params.alpha)
    time = 0.0
    for (u, v), f in flows.items():
        c = net.c(u, v)
        time = max(time, f / c if c > 0 else math.inf)
    return RepairPlan("ftr", params, best_parent, betas, flows, time,
                      lower_bound=t_star)
