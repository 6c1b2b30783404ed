"""LP machinery for flexible repair traffic (paper problems (1) and (5)).

Key building blocks:

* ``minmax_time_star`` — problem (1) over a Theorem-1-form region with per-
  provider rate caps beta_i <= t*c_i: exact via bisection.  For a fixed t the
  candidate set {0 <= beta_i <= min(t*c_i, alpha)} has a coordinate-wise
  maximum point, and every sigma_j is coordinate-wise non-decreasing, so
  feasibility at time t holds iff the max point satisfies all constraints.

* ``min_traffic_at_time`` — secondary objective: minimize total generated
  traffic sum(beta) at the optimal time (the min-max LP has many optima; the
  executor prefers the cheapest).  Solved exactly and LP-free by the
  level-cut oracle (``repro_torch.core.witness``); ``witness="lp"`` falls back to
  scipy's HiGHS via the exact LP-dual encoding of "sum of the m smallest
  >= x":

      exists lam (free), mu_i >= 0:  m*lam - sum_i mu_i >= x,
                                     lam - mu_i <= beta_i  for all i.

* ``tree_optimal_time`` — problem (5)/(6): optimal flexible time on a fixed
  regeneration tree.  For fixed t each tree edge (u,v) either satisfies
  t*c(u,v) >= alpha (re-encoding makes it unconstraining, Section V-B) or
  imposes  sum_{x in S(u)} beta_x <= t*c(u,v); the induced set is convex, so
  bisection on t with an LP feasibility oracle is exact per tree.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .params import Edge
from .regions import FeasibleRegion
from . import witness as _witness

BISECT_ITERS = 60   # star bisection depth
_TOL = 1e-9


# ---------------------------------------------------------------------------
# Star topology (FR)
# ---------------------------------------------------------------------------

def _star_feasible_at(t: float, caps: Sequence[float], region: FeasibleRegion,
                      alpha: float) -> bool:
    beta_hat = [min(t * c, alpha) for c in caps]
    return region.contains(beta_hat, tol=1e-12)


def minmax_time_star(caps: Sequence[float], region: FeasibleRegion,
                     alpha: float) -> float:
    """Exact optimum of problem (1) for a star topology.  A zero-capacity
    direct link is fine where beta_i = 0 is allowed: the max-point test
    handles it (beta_hat_i = 0)."""
    hi = 1.0
    while not _star_feasible_at(hi, caps, region, alpha):
        hi *= 2.0
        if hi > 1e18:
            return math.inf
    lo = 0.0
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        if _star_feasible_at(mid, caps, region, alpha):
            hi = mid
        else:
            lo = mid
    return hi


def min_traffic_at_time(t: float, caps: Sequence[float], region: FeasibleRegion,
                        alpha: float, witness: str = "exact") -> List[float]:
    """Min sum(beta) subject to beta in region, 0 <= beta_i <= min(t*c_i, alpha).

    ``witness="exact"`` (default) is the LP-free level-cut oracle
    (:mod:`repro_torch.core.witness`); ``witness="lp"`` keeps the
    scipy/HiGHS solve as the correctness oracle (falls through to the exact
    oracle when the LP fails at the feasibility boundary).
    """
    if witness not in ("exact", "lp"):
        raise ValueError(f"unknown witness engine {witness!r}")
    ub = [min(t * c, alpha) for c in caps]
    if witness == "lp":
        sol = _min_traffic_lp(ub, region)
        if sol is not None:
            return sol
    return _witness.level_cut(ub, region)


def _min_traffic_lp(ub: Sequence[float], region: FeasibleRegion) -> Optional[List[float]]:
    d = len(ub)
    k = region.k
    # variables z = [beta (d), lam (k), mu (k*d)]
    nv = d + k + k * d
    c = np.zeros(nv)
    c[:d] = 1.0
    A, b = [], []
    for j in range(1, k + 1):
        m = region.d - region.k + j
        # -m*lam_j + sum_i mu_ji <= -x_j
        row = np.zeros(nv)
        row[d + (j - 1)] = -m
        row[d + k + (j - 1) * d: d + k + j * d] = 1.0
        A.append(row)
        b.append(-region.x[j - 1])
        # lam_j - mu_ji - beta_i <= 0
        for i in range(d):
            row = np.zeros(nv)
            row[d + (j - 1)] = 1.0
            row[d + k + (j - 1) * d + i] = -1.0
            row[i] = -1.0
            A.append(row)
            b.append(0.0)
    bounds = [(0.0, u) for u in ub] + [(None, None)] * k + [(0.0, None)] * (k * d)
    from scipy.optimize import linprog

    res = linprog(c, A_ub=np.array(A), b_ub=np.array(b), bounds=bounds,
                   method="highs")
    if not res.success:
        return None
    beta = list(res.x[:d])
    # numerical safety: if a sigma constraint is violated by rounding, nudge up
    if not region.contains(beta, tol=1e-7):
        return None
    return beta


# ---------------------------------------------------------------------------
# Water-filling (leximin) oracle for laminar caps
# ---------------------------------------------------------------------------

def waterfill_max(ub: Sequence[float], laminar: Sequence[Tuple[Sequence[int], float]],
                  ) -> List[float]:
    """Leximin-maximal vector under per-coordinate caps ``ub`` and laminar
    set caps ``laminar`` = [(coordinate index list, bound), ...].

    Laminar caps form a polymatroid; the water-filled (lexicographically
    optimal) maximal vector simultaneously maximizes every sum-of-m-smallest
    sigma_m over the polytope (Fujishige's lexicographically optimal bases).
    Used as an exact, LP-free feasibility oracle for the fixed-tree problem;
    cross-validated against the scipy LP by the reference's tests.
    """
    d = len(ub)
    ub_arr = np.asarray(ub, dtype=np.float64)
    v = np.zeros(d)
    active = np.ones(d, dtype=bool)
    if laminar:
        inc = np.zeros((len(laminar), d), dtype=np.float64)
        bnd = np.empty(len(laminar))
        for si, (S, B) in enumerate(laminar):
            for i in S:
                inc[si, i] = 1.0
            bnd[si] = B
    else:
        inc = np.zeros((0, d))
        bnd = np.zeros(0)
    while active.any():
        lam = np.inf
        freeze_set = -1
        # candidate level from per-coordinate caps
        coord_min = ub_arr[active].min()
        lam = coord_min
        if len(bnd):
            na = inc @ active
            frozen_sum = inc @ (v * ~active)
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = np.where(na > 0, (bnd - frozen_sum) / np.maximum(na, 1), np.inf)
            si = int(np.argmin(cand))
            if cand[si] < lam - 1e-15:
                lam = cand[si]
                freeze_set = si
        lam = max(lam, 0.0)
        if freeze_set >= 0:
            members = (inc[freeze_set] > 0) & active
            v[members] = lam
            active &= ~members
        else:
            members = active & (ub_arr <= lam + 1e-15)
            v[members] = ub_arr[members]
            active &= ~members
    return v.tolist()


# ---------------------------------------------------------------------------
# Fixed-tree flexible traffic (FTR inner problem)
# ---------------------------------------------------------------------------

def _subtree_sets(parent: Dict[int, int], d: int) -> Dict[int, List[int]]:
    children: Dict[int, List[int]] = {}
    for u, p in parent.items():
        children.setdefault(p, []).append(u)
    subs: Dict[int, List[int]] = {}

    def visit(u: int) -> List[int]:
        acc = [u]
        for ch in children.get(u, []):
            acc.extend(visit(ch))
        subs[u] = acc
        return acc

    for r in children.get(0, []):
        visit(r)
    return subs


def tree_feasible_at_time(t: float, parent: Dict[int, int],
                          cap_of_edge: Dict[Edge, float],
                          region: FeasibleRegion, alpha: float,
                          minimize_traffic: bool = False,
                          witness: str = "exact") -> Optional[List[float]]:
    """Feasibility oracle: is there beta >= 0 in ``region`` such that every
    tree edge carries min(subtree-sum, alpha) <= t * c(edge)?  Returns a
    witness beta (len d) or None.

    For fixed t the edge constraint resolves deterministically:
      * t*c >= alpha  -> edge never binds (interior re-encoding caps the flow)
      * t*c <  alpha  -> sum_{x in S(u)} beta_x <= t*c

    Default oracle is the exact water-fill (leximin maximizes every sigma_j
    over the laminar polytope); ``minimize_traffic=True`` additionally
    minimizes total traffic among feasible witnesses (used for the final
    plan) — by the exact level cut of the water-fill point, or via the
    scipy LP when ``witness="lp"``.
    """
    if witness not in ("exact", "lp"):
        raise ValueError(f"unknown witness engine {witness!r}")
    d = region.d
    subs = _subtree_sets(parent, d)
    caps: List[Tuple[List[int], float]] = []  # (subtree provider list, bound)
    for u, p in parent.items():
        c = cap_of_edge[(u, p)]
        bound = t * c
        if bound >= alpha - 1e-12:
            continue
        caps.append((subs[u], bound))
    # per-provider implicit cap beta_i <= alpha
    ub = [alpha] * d

    if minimize_traffic and witness == "lp":
        # exact LP oracle + solver-chosen traffic-minimal vertex
        return _tree_lp(caps, ub, region)
    wf = waterfill_max(ub, [([x - 1 for x in S], B) for S, B in caps])
    if not region.contains(wf, tol=1e-9):
        return None
    if minimize_traffic:
        # a uniform level cap commutes with the water-fill (freeze levels
        # only rise), so the traffic-minimal point is a level cut of wf
        return _witness.tree_min_traffic(wf, region)
    return wf


def _tree_lp(caps, ub, region: FeasibleRegion) -> Optional[List[float]]:
    d, k = region.d, region.k
    nv = d + k + k * d
    c = np.zeros(nv)
    c[:d] = 1.0  # among feasible points prefer low total traffic
    A, b = [], []
    for nodes, bound in caps:
        row = np.zeros(nv)
        for x in nodes:
            row[x - 1] = 1.0
        A.append(row)
        b.append(bound)
    for j in range(1, k + 1):
        m = region.d - region.k + j
        row = np.zeros(nv)
        row[d + (j - 1)] = -m
        row[d + k + (j - 1) * d: d + k + j * d] = 1.0
        A.append(row)
        b.append(-region.x[j - 1])
        for i in range(d):
            row = np.zeros(nv)
            row[d + (j - 1)] = 1.0
            row[d + k + (j - 1) * d + i] = -1.0
            row[i] = -1.0
            A.append(row)
            b.append(0.0)
    bounds = [(0.0, u) for u in ub] + [(None, None)] * k + [(0.0, None)] * (k * d)
    from scipy.optimize import linprog

    res = linprog(c, A_ub=np.array(A), b_ub=np.array(b), bounds=bounds,
                   method="highs")
    if not res.success:
        return None
    beta = list(res.x[:d])
    if not region.contains(beta, tol=1e-7):
        return None
    return beta


def tree_optimal_time(parent: Dict[int, int], cap_of_edge: Dict[Edge, float],
                      region: FeasibleRegion, alpha: float,
                      iters: int = 40, minimize_traffic: bool = False,
                      witness: str = "exact",
                      ) -> Tuple[float, Optional[List[float]]]:
    """Problem (5): min t such that a feasible beta exists on this tree.

    Bisection with the water-fill oracle; ``minimize_traffic=True`` extracts
    the traffic-minimal witness at the final time (exact level cut by
    default, scipy's vertex with ``witness="lp"``).
    """
    pos = [c for c in cap_of_edge.values()]
    if any(c <= 0 for c in pos):
        return math.inf, None
    hi = max(alpha / c for c in pos) * (1 + 1e-9) + 1e-12
    if tree_feasible_at_time(hi, parent, cap_of_edge, region, alpha) is None:
        while hi < 1e18:
            hi *= 2
            if tree_feasible_at_time(hi, parent, cap_of_edge, region, alpha) is not None:
                break
        else:
            return math.inf, None
    lo = 0.0
    beta = None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        w = tree_feasible_at_time(mid, parent, cap_of_edge, region, alpha)
        if w is not None:
            hi, beta = mid, w
        else:
            lo = mid
    if minimize_traffic:
        w = tree_feasible_at_time(hi, parent, cap_of_edge, region, alpha,
                                  minimize_traffic=True, witness=witness)
        if w is not None:
            beta = w
    if beta is None:
        beta = tree_feasible_at_time(hi, parent, cap_of_edge, region, alpha)
    return hi, beta
