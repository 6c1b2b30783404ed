"""Star-topology schemes: conventional STAR [3] and Flexible Regeneration
(FR, paper Section III)."""
from __future__ import annotations

from typing import Dict, List

from .params import CodeParams, OverlayNetwork, RepairPlan, tree_flows
from .regions import FeasibleRegion, heuristic_region, msr_region
from . import lp


def _star_parent(d: int) -> Dict[int, int]:
    return {i: 0 for i in range(1, d + 1)}


def _star_time(flows: Dict, caps: List[float], d: int) -> float:
    """max_i f(i,0)/c_i with inf on nonpositive links (shared by every star
    planner)."""
    if not d:
        return 0.0
    return max((flows[(i, 0)] / caps[i - 1]) if caps[i - 1] > 0 else float("inf")
               for i in range(1, d + 1))


def plan_star(net: OverlayNetwork, params: CodeParams) -> RepairPlan:
    """Conventional regeneration: uniform beta from every provider straight
    to the newcomer (Dimakis et al. [3])."""
    d = params.d
    b = params.beta
    betas = [b] * d
    parent = _star_parent(d)
    flows = tree_flows(parent, betas, params.alpha)
    time = _star_time(flows, net.direct_caps(), d)
    return RepairPlan("star", params, parent, betas, flows, time)


def fr_closed_form_msr(caps: List[float], params: CodeParams) -> List[float]:
    """Closed-form optimum of problem (4) at MSR (Section III-B).

    Sort capacities ascending; the d-k+1 slowest providers carry traffic
    proportional to their capacity, the rest match the (d-k+1)-th:
        beta_j = c_j * M / (k * sum_{i<=d-k+1} c_i)   for j <= d-k+1
        beta_j = beta_{d-k+1}                          otherwise.
    """
    d, k, M = params.d, params.k, params.M
    order = sorted(range(d), key=lambda i: caps[i])
    m = d - k + 1
    denom = sum(caps[order[i]] for i in range(m))
    betas = [0.0] * d
    if denom <= 0:
        raise ZeroDivisionError("the d-k+1 slowest links have zero capacity")
    for rank, i in enumerate(order):
        if rank < m:
            betas[i] = caps[i] * M / (k * denom)
        else:
            betas[i] = caps[order[m - 1]] * M / (k * denom)
    return betas


def plan_fr(net: OverlayNetwork, params: CodeParams,
            region: FeasibleRegion | None = None,
            minimize_traffic: bool = True,
            witness: str = "exact") -> RepairPlan:
    """Flexible Regeneration: star topology, non-uniform beta chosen from the
    (maximum at MSR / heuristic otherwise) feasible region by solving the
    min-max problem (1).

    ``witness`` picks the traffic-minimal witness engine at the optimal
    time: the exact level-cut oracle (default) or the scipy LP
    (``witness="lp"``, kept as the correctness oracle).
    """
    # eager: the MSR closed form never consults
    # the witness engine, so a typo would otherwise pass silently
    if witness not in ("exact", "lp"):
        raise ValueError(f"unknown witness engine {witness!r}")
    d = params.d
    caps = net.direct_caps()
    if region is None:
        region = msr_region(params) if params.is_msr else heuristic_region(params)

    if params.is_msr and all(c > 0 for c in caps):
        betas = fr_closed_form_msr(caps, params)
        time = max(betas[i] / caps[i] for i in range(d))
        # cross-check against the bisection optimum (cheap, exact)
        t_star = lp.minmax_time_star(caps, region, params.alpha)
        if t_star < time * (1 - 1e-9):  # pragma: no cover - closed form is optimal
            time = t_star
            betas = lp.min_traffic_at_time(t_star, caps, region, params.alpha,
                                           witness=witness)
    else:
        time = lp.minmax_time_star(caps, region, params.alpha)
        if minimize_traffic:
            betas = lp.min_traffic_at_time(time, caps, region, params.alpha,
                                           witness=witness)
        else:
            betas = [min(time * c, params.alpha) for c in caps]

    parent = _star_parent(d)
    flows = tree_flows(parent, betas, params.alpha)
    t = _star_time(flows, caps, d)
    return RepairPlan("fr", params, parent, betas, flows, max(t, 0.0),
                      lower_bound=time)


def plan_shah(net: OverlayNetwork, params: CodeParams,
              beta_max: float | None = None) -> RepairPlan:
    """Baseline [6] (Shah et al.): beta_i in [0, beta_max], sum beta_i >= gamma.

    With gamma chosen minimally for the MDS property (see
    ``regions.shah_region_thresholds``).  Greedy water-filling from the
    fastest links minimizes the max transfer time over the box-simplex set.
    """
    from .regions import shah_region_thresholds

    d = params.d
    caps = net.direct_caps()
    if beta_max is None:
        beta_max = params.alpha  # most permissive per-provider cap
    gamma = shah_region_thresholds(params, beta_max)

    # bisection on t: achievable iff sum_i min(t*c_i, beta_max) >= gamma
    lo, hi = 0.0, 1.0
    def tot(t: float) -> float:
        return sum(min(t * c, beta_max) for c in caps)
    while tot(hi) < gamma:
        hi *= 2
        if hi > 1e18:
            return RepairPlan("shah", params, _star_parent(d), [0.0] * d, {},
                              float("inf"))
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if tot(mid) >= gamma:
            hi = mid
        else:
            lo = mid
    t = hi
    betas = [min(t * c, beta_max) for c in caps]
    # trim surplus from the slowest contributors (they set the clock)
    surplus = sum(betas) - gamma
    for i in sorted(range(d), key=lambda i: caps[i]):
        if surplus <= 0:
            break
        cut = min(surplus, betas[i])
        betas[i] -= cut
        surplus -= cut
    parent = _star_parent(d)
    flows = tree_flows(parent, betas, params.alpha)
    time = _star_time(flows, caps, d)
    return RepairPlan("shah", params, parent, betas, flows, time)
