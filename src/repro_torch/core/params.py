"""Code parameters, overlay networks and repair plans.

Units: data is measured in *blocks* (the paper's quantum, Section II); link
capacities are in blocks/second.  All of ``M``, ``alpha``, ``beta`` are block
counts and may be fractional during planning (Section III-C: fractional
solutions are rounded up by the executor; tests check rounding keeps MDS).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

Edge = Tuple[int, int]  # (child u, parent v): data flows u -> v toward root


@functools.lru_cache(maxsize=4096)
def uniform_beta(M: float, k: int, d: int, alpha: float) -> float:
    """Per-provider repair traffic of the conventional scheme (Theorem 3).

    The smallest b >= 0 with  sum_{j=1..k} min((d-k+j)*b, alpha) = M.
    Exists iff k*alpha >= M and d >= k.  Cached: the planners evaluate this
    once per edge comparison on the Monte-Carlo hot path.
    """
    if d < k:
        raise ValueError(f"need d >= k, got d={d} k={k}")
    if k * alpha < M - 1e-9:
        raise ValueError(f"k*alpha={k * alpha} < M={M}: file cannot be stored")
    # Term j saturates (== alpha) once b >= alpha/(d-k+j); larger j saturates
    # first.  Try s = number of saturated terms (the s largest j's).
    for s in range(k + 1):
        mult = sum(d - k + j for j in range(1, k - s + 1))  # unsaturated terms
        if mult == 0:
            b = alpha / max(d - k + 1, 1)
            if s * alpha >= M - 1e-9:
                return b
            continue
        b = (M - s * alpha) / mult
        if b < -1e-12:
            continue
        b = max(b, 0.0)
        # consistency: exactly the top-s terms saturated at this b
        ok = True
        for j in range(1, k + 1):
            sat = (d - k + j) * b >= alpha * (1 - 1e-12)
            should_sat = j > k - s
            # allow boundary equality to count either way
            if sat != should_sat and abs((d - k + j) * b - alpha) > 1e-9 * max(alpha, 1.0):
                ok = False
                break
        if ok:
            return b
    raise ArithmeticError("uniform_beta: no consistent piecewise solution found")


def msr_point(M: float, k: int, d: int) -> Tuple[float, float]:
    """(alpha, beta) at the minimum-storage regenerating point."""
    alpha = M / k
    return alpha, alpha / (d - k + 1)


def mbr_point(M: float, k: int, d: int) -> Tuple[float, float]:
    """(alpha, beta) at the minimum-bandwidth regenerating point [3]."""
    beta = 2.0 * M / (k * (2 * d - k + 1))
    return d * beta, beta


@dataclasses.dataclass(frozen=True)
class CodeParams:
    """(n, k) MDS code regenerated from d providers."""

    n: int
    k: int
    d: int
    M: float              # file size in blocks
    alpha: float          # blocks stored per node

    def __post_init__(self):
        if not (self.k <= self.d <= self.n - 1):
            raise ValueError(f"need k <= d <= n-1: n={self.n} k={self.k} d={self.d}")
        if self.alpha < self.M / self.k - 1e-9:
            raise ValueError("alpha below MSR point")

    @property
    def beta(self) -> float:
        """Uniform per-provider repair traffic of the conventional scheme."""
        return uniform_beta(self.M, self.k, self.d, self.alpha)

    @property
    def is_msr(self) -> bool:
        return abs(self.alpha - self.M / self.k) <= 1e-9 * max(self.M, 1.0)

    @classmethod
    def msr(cls, n: int, k: int, d: int, M: float) -> "CodeParams":
        return cls(n=n, k=k, d=d, M=M, alpha=M / k)

    @classmethod
    def mbr(cls, n: int, k: int, d: int, M: float) -> "CodeParams":
        alpha, _ = mbr_point(M, k, d)
        return cls(n=n, k=k, d=d, M=M, alpha=alpha)


class OverlayNetwork:
    """Complete directed overlay over the newcomer (node 0) and d providers.

    ``cap[u][v]`` is the available bandwidth u -> v in blocks/sec.  Node 0 is
    always the newcomer; nodes 1..d are providers (paper Section II).
    """

    def __init__(self, cap: Sequence[Sequence[float]]):
        self.cap = [list(row) for row in cap]
        self.num_nodes = len(self.cap)
        if any(len(row) != self.num_nodes for row in self.cap):
            raise ValueError("capacity matrix must be square")

    @property
    def d(self) -> int:
        return self.num_nodes - 1

    def c(self, u: int, v: int) -> float:
        return self.cap[u][v]

    def direct_caps(self) -> List[float]:
        """Provider -> newcomer capacities c_i, i = 1..d."""
        return [self.cap[i][0] for i in range(1, self.num_nodes)]

    @classmethod
    def star_only(cls, direct: Sequence[float], cross: float = 0.0) -> "OverlayNetwork":
        """Overlay with given provider->newcomer capacities; all
        provider<->provider links set to ``cross``."""
        d = len(direct)
        cap = [[cross] * (d + 1) for _ in range(d + 1)]
        for i, c in enumerate(direct, start=1):
            cap[i][0] = c
        for i in range(d + 1):
            cap[i][i] = 0.0
        return cls(cap)

    @classmethod
    def from_edges(cls, d: int, edges: Dict[Edge, float], default: float = 0.0) -> "OverlayNetwork":
        cap = [[default] * (d + 1) for _ in range(d + 1)]
        for i in range(d + 1):
            cap[i][i] = 0.0
        for (u, v), c in edges.items():
            cap[u][v] = c
        return cls(cap)


@dataclasses.dataclass
class RepairPlan:
    """A fully-specified single-newcomer regeneration.

    ``parent[u]`` for u in 1..d gives the tree edge u -> parent[u] (parent 0
    is the newcomer).  ``betas[i-1]`` is the number of coded blocks
    *generated* by provider i from its local alpha blocks.  ``flows[(u,v)]``
    is the number of blocks transmitted on tree edge (u, v).
    """

    scheme: str
    params: CodeParams
    parent: Dict[int, int]
    betas: List[float]
    flows: Dict[Edge, float]
    time: float
    lower_bound: Optional[float] = None  # optional certificate (e.g. LP bound)

    @property
    def total_traffic(self) -> float:
        return sum(self.flows.values())

    def subtree_nodes(self, u: int) -> List[int]:
        children: Dict[int, List[int]] = {}
        for c_, p in self.parent.items():
            children.setdefault(p, []).append(c_)
        out, stack = [], [u]
        while stack:
            x = stack.pop()
            out.append(x)
            stack.extend(children.get(x, []))
        return out

    def validate(self, net: OverlayNetwork, tol: float = 1e-6) -> None:
        """Structural checks: it is a tree rooted at 0; flows/time consistent."""
        d = self.params.d
        assert set(self.parent.keys()) == set(range(1, d + 1)), "every provider needs a parent"
        # acyclicity / rooted at 0
        for u in range(1, d + 1):
            seen, x = set(), u
            while x != 0:
                assert x not in seen, f"cycle through {x}"
                seen.add(x)
                x = self.parent[x]
        # flow consistency with betas: f(u, p(u)) = min(sum_{x in S(u)} beta_x, alpha)
        for u in range(1, d + 1):
            sub = self.subtree_nodes(u)
            expect = min(sum(self.betas[x - 1] for x in sub), self.params.alpha)
            got = self.flows[(u, self.parent[u])]
            assert abs(got - expect) <= tol * max(1.0, expect), (
                f"flow on ({u},{self.parent[u]}): got {got}, expect {expect}")
        # reported time
        t = plan_time(self, net)
        assert t <= self.time * (1 + 1e-6) + tol, f"time understated: {self.time} < {t}"


def plan_time(plan: RepairPlan, net: OverlayNetwork) -> float:
    """Regeneration time  max f(u,v)/c(u,v)  (store-and-forward, paper eq. in §II)."""
    t = 0.0
    for (u, v), f in plan.flows.items():
        if f <= 1e-12:
            continue
        c = net.c(u, v)
        if c <= 0:
            return math.inf
        t = max(t, f / c)
    return t


def tree_flows(parent: Dict[int, int], betas: Sequence[float], alpha: float) -> Dict[Edge, float]:
    """Per-edge flows for a tree with per-provider generation ``betas``.

    f(u, parent(u)) = min(sum of betas in the subtree rooted at u, alpha) —
    interior nodes re-encode down to alpha blocks when they hold more
    (Section V-A).
    """
    children: Dict[int, List[int]] = {}
    for u, p in parent.items():
        children.setdefault(p, []).append(u)
    flows: Dict[Edge, float] = {}
    subtotal: Dict[int, float] = {}

    def visit(u: int) -> float:
        s = betas[u - 1]
        for c_ in children.get(u, []):
            s += min(visit(c_), alpha)
        subtotal[u] = s
        return s

    for r in children.get(0, []):
        visit(r)
    for u, p in parent.items():
        flows[(u, p)] = min(subtotal[u], alpha)
    return flows
