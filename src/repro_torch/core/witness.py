"""Exact combinatorial min-traffic witness oracle (star and tree cases).

The planners need a *traffic-minimal* witness beta at the optimal repair
time: problem (1)'s secondary objective for FR, and the final flexible
betas on FTR's winning tree.  This module computes it LP-free, by an exact
O(d log d) closed form (a copy of ``repro.core.witness``).

Structure.  In both cases the witness problem is

    min sum(beta)   s.t.   sigma_j(beta) >= x_j  (j = 1..k),   0 <= beta <= ub

where sigma_j is the sum of the (d-k+j) smallest components (Theorem 1) and
``ub`` is a coordinate-wise *maximal* feasible point:

* star (``lp.min_traffic_at_time``): ub_i = min(t * c_i, alpha) — the
  Theorem-1 max point the bisection already certified;
* tree (``lp._tree_lp``): ub = the water-fill witness of the laminar
  subtree caps at time t (``lp.waterfill_max``).
  A uniform level cap commutes with the water-fill — freeze levels only rise
  during filling, so capping every coordinate at ``lam`` before filling
  equals filling first and clipping at ``lam`` (min(wf, lam)).  The laminar
  caps therefore stay satisfied under any level cut of ``wf``, which reduces
  the tree case to the star case with ub = wf.

Level-cut solution.  Candidates beta = min(ub, lam) sweep a monotone family:
every sigma_j is non-decreasing in lam, so the minimal feasible level is
determined per constraint.  With s = sort(ub) ascending, prefix sums
S_p = s_1 + ... + s_p and m_j = d - k + j,

    sum_{i <= m_j} min(s_i, lam)  =  min_p ( S_p + (m_j - p) * lam ),

hence sigma_j(min(ub, lam)) >= x_j  iff  lam >= (x_j - S_p) / (m_j - p) for
every p < m_j, and the exact optimal level is

    lam* = max(0, max_{j, p < m_j} (x_j - S_p) / (m_j - p)).

``min(ub, lam*)`` attains the LP optimum of sum(beta).

Tie-break contract.  The LP optimum can be a face, not a point; a witness
is only reproducible if its position on that face is pinned.  This oracle
always returns the *level-cut point* ``min(ub, lam*)`` — the most balanced
optimal vector (it minimizes the maximum coordinate over the optimal face),
deterministic, independent of batch composition, and exempt from solver
internals.  On star instances this coincides with HiGHS's vertex choice.
On degenerate tree faces HiGHS's dual simplex may
return a different vertex of the same face — equal generated traffic
sum(beta) and equal repair time, but individual betas (and hence relayed
bytes on non-binding edges) can differ; the level-cut point is the
canonical witness, and ``witness="lp"`` on the planners reproduces the old
solver-chosen vertex exactly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .regions import FeasibleRegion

__all__ = [
    "level_cut_batch",
    "level_cut",
    "tree_min_traffic",
]


_FEAS_TOL = 1e-7    # matches the LP acceptance tolerance in .lp


def min_level_batch(ub: np.ndarray, region: FeasibleRegion,
                    lanes: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact minimal level ``lam*`` per lane such that ``min(ub, lam*)``
    satisfies every Theorem-1 constraint of ``region``.

    ``ub`` is (B, d).  Returns (B,).  Every live lane's ``ub`` must itself
    satisfy the region (the callers' bisections certify exactly that);
    an infeasible live lane raises ValueError — the same contract the old
    scipy-absent greedy enforced — instead of returning a silently invalid
    witness.  Lanes outside ``lanes`` are not checked (their result is
    discarded by the callers).
    """
    ub = np.asarray(ub, dtype=np.float64)
    B, d = ub.shape
    k = region.k
    s = np.sort(ub, axis=1)
    S = np.concatenate([np.zeros((B, 1)), np.cumsum(s, axis=1)], axis=1)
    p = np.arange(d)                                    # prefix sizes 0..d-1
    m = d - k + np.arange(1, k + 1)                     # m_j, shape (k,)
    x = np.asarray(region.x, dtype=np.float64)
    # sigma_j(ub) = S[m_j] is the largest reachable value of constraint j
    slack = x[None, :] - S[:, m]                        # (B, k)
    bad = (slack > _FEAS_TOL * np.maximum(1.0, np.abs(x))[None, :]).any(axis=1)
    if lanes is not None:
        bad &= lanes
    if bad.any():
        raise ValueError(
            f"infeasible even at the coordinate-wise max point in "
            f"{int(bad.sum())} of {B} lanes (first: lane "
            f"{int(np.argmax(bad))})")
    denom = m[None, :, None] - p[None, None, :]         # (1, k, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        cand = (x[None, :, None] - S[:, None, :d]) / denom
    cand = np.where(denom > 0, cand, -np.inf)           # only p < m_j bind
    return np.maximum(cand.max(axis=(1, 2)), 0.0)


def level_cut_batch(ub: np.ndarray, region: FeasibleRegion,
                    lanes: Optional[np.ndarray] = None) -> np.ndarray:
    """Traffic-minimal witnesses ``min(ub, lam*)`` for a (B, d) batch of
    coordinate-wise maximal points ``ub`` (see module docstring)."""
    ub = np.asarray(ub, dtype=np.float64)
    lam = min_level_batch(ub, region, lanes=lanes)
    return np.minimum(ub, lam[:, None])


def level_cut(ub: Sequence[float], region: FeasibleRegion) -> List[float]:
    """Scalar wrapper of :func:`level_cut_batch` (one lane) — the scalar
    planners share the batch arithmetic bit for bit."""
    return level_cut_batch(np.asarray(ub, dtype=np.float64)[None, :],
                           region)[0].tolist()


# ---------------------------------------------------------------------------
# Tree case (FTR): traffic-minimal betas on a fixed regeneration tree
# ---------------------------------------------------------------------------

def tree_min_traffic(wf: Sequence[float], region: FeasibleRegion,
                     ) -> List[float]:
    """Scalar tree witness from an already-computed water-fill point ``wf``
    (the feasibility witness at the target time): its level cut is the
    traffic-minimal vector on the tree (see module docstring)."""
    return level_cut(wf, region)
