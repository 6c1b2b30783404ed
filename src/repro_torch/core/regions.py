"""Feasible regions of repair-traffic vectors (paper Section III).

A *feasible region* D subset R^d is a set of repair-bandwidth vectors
beta = (beta_1..beta_d) such that the MDS property is maintained whenever
every repair round picks beta from D (min-cut condition, eq. (3)).

Theorem 1: a maximal region is  {beta : sigma_j(beta) >= x_j, j=1..k}  with
0 <= x_1 <= ... <= x_k <= alpha and sum x_j >= M, where sigma_j(beta) is the
sum of the (d-k+j) smallest components of beta.

Theorem 2 (MSR, alpha = M/k): the unique maximum region is
{beta : sigma_1(beta) >= M/k}.

Section III-C (non-MSR): no maximum region exists (Theorem 6); the paper's
heuristic region is  {beta : sigma_j(beta) >= min((d-k+j)*beta_u, alpha)}
with beta_u the uniform traffic of the conventional scheme — it always
contains the uniform point, so flexible repair is never worse than STAR.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .params import CodeParams


def sigma(j: int, beta: Sequence[float], k: int, d: int) -> float:
    """sigma_j(beta): sum of the (d-k+j) smallest components (1 <= j <= k)."""
    m = d - k + j
    if not (1 <= j <= k) or m > len(beta):
        raise ValueError(f"sigma_{j} undefined for d={d} k={k} len={len(beta)}")
    return sum(sorted(beta)[:m])


@dataclasses.dataclass(frozen=True)
class FeasibleRegion:
    """Maximal region in Theorem-1 form: sigma_j(beta) >= x[j-1], j = 1..k."""

    k: int
    d: int
    x: tuple  # length k, non-decreasing

    def __post_init__(self):
        if len(self.x) != self.k:
            raise ValueError("need one threshold per j = 1..k")
        for a, b in zip(self.x, self.x[1:]):
            if a > b + 1e-9:
                raise ValueError(f"thresholds must be non-decreasing: {self.x}")

    def contains(self, beta: Sequence[float], tol: float = 1e-9) -> bool:
        return all(
            sigma(j, beta, self.k, self.d) >= self.x[j - 1] - tol
            for j in range(1, self.k + 1)
        )

    def mincut(self, alpha: float) -> float:
        """MC(D, alpha) from eq. (3): sum_j min(min_{beta in D} sigma_j, alpha).

        For a Theorem-1-form region, min over D of sigma_j is exactly x_j
        (each constraint is tight somewhere on the boundary).
        """
        return sum(min(xj, alpha) for xj in self.x)

    def is_feasible(self, params: CodeParams, tol: float = 1e-9) -> bool:
        """Min-cut condition MC(D, alpha) >= M."""
        return self.mincut(params.alpha) >= params.M - tol


def msr_region(params: CodeParams) -> FeasibleRegion:
    """Theorem 2: the maximum region at MSR — only sigma_1 >= M/k binds.

    Encoded in Theorem-1 form with x_j = alpha for j >= 2 (implied by
    sigma_j >= sigma_1 and the alpha cap; this is the same set).
    """
    if not params.is_msr:
        raise ValueError("msr_region requires alpha == M/k")
    a = params.M / params.k
    return FeasibleRegion(k=params.k, d=params.d, x=tuple([a] * params.k))


def heuristic_region(params: CodeParams) -> FeasibleRegion:
    """Section III-C heuristic region for any alpha >= M/k.

    x_j = min((d-k+j) * beta_uniform, alpha).  Contains the uniform point;
    reduces to the Theorem-2 maximum region at MSR (where (d-k+1)*beta =
    alpha, so every threshold is alpha... and sigma_j >= sigma_1 makes the
    j = 1 constraint the binding one).
    """
    b = params.beta
    x = tuple(
        min((params.d - params.k + j) * b, params.alpha)
        for j in range(1, params.k + 1)
    )
    return FeasibleRegion(k=params.k, d=params.d, x=x)


def uniform_point(params: CodeParams) -> List[float]:
    """The conventional scheme's beta = (beta, ..., beta); always in the
    heuristic region (paper Section III-C)."""
    return [params.beta] * params.d


def shah_region_thresholds(params: CodeParams, beta_max: float) -> float:
    """Baseline [6] (Shah et al.): beta_i in [0, beta_max], sum beta_i >= gamma.

    Returns the smallest gamma such that the box-simplex set is a feasible
    region.  Worst case of sigma_j over the set puts beta_max into the k - j
    *largest* coordinates, so min sigma_j = gamma - (k - j) * beta_max and we
    need that >= min((d-k+j) beta_u, alpha) for all j.
    """
    b = params.beta
    gamma = 0.0
    for j in range(1, params.k + 1):
        need = min((params.d - params.k + j) * b, params.alpha)
        gamma = max(gamma, need + (params.k - j) * beta_max)
    return gamma


def theorem6_example():
    """The two incomparable maximal regions of Example 1 (n=5, k=3, d=4,
    M=12, alpha=6): there is no maximum region (Theorem 6)."""
    p = CodeParams(n=5, k=3, d=4, M=12, alpha=6)
    d1 = FeasibleRegion(k=3, d=4, x=(1, 5, 6))
    d2 = FeasibleRegion(k=3, d=4, x=(2, 4, 6))
    return p, d1, d2
