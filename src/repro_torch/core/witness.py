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
    "min_traffic_batch",
    "tree_min_traffic",
    "tree_traffic_batch",
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
# Star case (FR): problem (1)'s secondary objective
# ---------------------------------------------------------------------------

def min_traffic_batch(t: np.ndarray, direct: np.ndarray,
                      region: FeasibleRegion, alpha: float,
                      lanes: Optional[np.ndarray] = None) -> np.ndarray:
    """Traffic-minimal star betas at the per-lane times ``t`` over direct
    capacities ``direct`` (B, d).  Lanes outside ``lanes``, or with a
    non-finite ``t``, return zeros."""
    t = np.asarray(t, dtype=np.float64)
    direct = np.asarray(direct, dtype=np.float64)
    live = np.isfinite(t) if lanes is None else (lanes & np.isfinite(t))
    ub = np.minimum(np.where(live, t, 0.0)[:, None] * direct, alpha)
    betas = level_cut_batch(ub, region, lanes=live)
    return np.where(live[:, None], betas, 0.0)


# ---------------------------------------------------------------------------
# Tree case (FTR): traffic-minimal betas on a fixed regeneration tree
# ---------------------------------------------------------------------------

def tree_traffic_batch(t: np.ndarray, parents: np.ndarray, caps: np.ndarray,
                       region: FeasibleRegion, alpha: float,
                       lanes: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched ``lp._tree_lp``: traffic-minimal betas at per-lane times ``t``
    on the trees ``parents`` (B, d+1) over capacity tensors ``caps``
    (B, d+1, d+1): one water-fill at ``t`` and its level cut.  Lanes outside
    ``lanes``, or with a non-finite ``t``, return zeros."""
    t = np.asarray(t, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.float64)
    parents = np.asarray(parents, dtype=np.int64)
    live = np.isfinite(t) if lanes is None else (lanes & np.isfinite(t))
    B, D1 = parents.shape
    inc = _subtree_masks(parents)[:, 1:, :]
    edge_caps = caps[np.arange(B)[:, None], np.arange(1, D1)[None, :],
                     parents[:, 1:]]
    bounds = np.where(live, t, 1.0)[:, None] * edge_caps
    wf = _waterfill(inc, np.where(bounds < alpha - 1e-12, bounds, np.inf),
                    alpha)
    betas = level_cut_batch(wf, region, lanes=live)
    return np.where(live[:, None], betas, 0.0)


def _subtree_masks(parents: np.ndarray) -> np.ndarray:
    """(B, d+1, d) float64, [b, u, x-1] = 1 iff provider x lies in u's
    subtree: log2(d+1) squarings of the one-step reachability."""
    P, D1 = parents.shape
    C = np.zeros((P, D1, D1))
    rows = np.arange(P)[:, None]
    node = np.arange(D1)[None, :]
    C[rows, node, node] = 1.0
    C[rows, node[:, 1:], parents[:, 1:]] = 1.0
    steps = 1
    while steps < D1:
        C = ((C @ C) > 0).astype(np.float64)
        steps *= 2
    return np.ascontiguousarray(C.transpose(0, 2, 1)[:, :, 1:])


def _waterfill(inc: np.ndarray, bnd: np.ndarray, alpha: float) -> np.ndarray:
    """Leximin-maximal vectors under the cap ``alpha`` and the laminar set
    caps ``bnd`` (+inf: inactive) of the sets ``inc`` (P, S, d): each round
    freezes every chain-minimal saturated set of every lane."""
    P, S, d = inc.shape
    chain = (inc @ inc.transpose(0, 2, 1)) > 0
    athr = alpha - 1e-15
    v = np.zeros((P, d))
    active = np.ones((P, d))
    X = np.empty((P, d, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        while True:
            X[..., 0] = active
            X[..., 1] = v * (1.0 - active)
            Y = inc @ X
            na = Y[..., 0]
            cand = (bnd - Y[..., 1]) / np.maximum(na, 1.0)
            np.copyto(cand, np.inf, where=na == 0)
            freezable = cand < athr
            if not freezable.any():
                np.copyto(v, alpha, where=active > 0)
                break
            chmin = np.where(chain, cand[:, None, :], np.inf).min(axis=2)
            setfreeze = freezable & (cand <= chmin)
            lamx = np.where(setfreeze[:, :, None] & (inc > 0),
                            cand[:, :, None], np.inf).min(axis=1)
            np.maximum(lamx, 0.0, out=lamx)
            fin = lamx < np.inf
            mfrz = fin | ~setfreeze.any(axis=1)[:, None]
            np.copyto(v, np.where(fin, lamx, alpha), where=mfrz & (active > 0))
            active = active * ~mfrz
            if not active.any():
                break
    return v


def tree_min_traffic(wf: Sequence[float], region: FeasibleRegion,
                     ) -> List[float]:
    """Scalar tree witness from an already-computed water-fill point ``wf``
    (the feasibility witness at the target time): its level cut is the
    traffic-minimal vector on the tree (see module docstring)."""
    return level_cut(wf, region)
