"""Cluster state: node health, rack placement, and the live capacity matrix.

Node identity is a *slot*: when slot ``x`` fails, a replacement host takes
the same slot, so the directed capacity matrix keeps its shape for the whole
simulation and plans map onto physical links by plain index pairs.

States form a 3-way machine per slot::

    HEALTHY --fail--> FAILED (queued) --start_repair--> REPAIRING
       ^                                                    |
       +---------------- complete_repair -------------------+

A REPAIRING slot that loses a provider reverts to FAILED (requeued by the
simulator).  ``unavailable`` counts FAILED + REPAIRING slots — an (n, k) MDS
code loses data when that exceeds n - k, i.e. fewer than k slots are
HEALTHY.

A FAILED slot is not necessarily empty: with partial-progress carryover the
replacement host keeps the blocks it already received before the abort (the
simulator's queue carries the per-link bank), so FAILED -> REPAIRING may
resume from banked work rather than from zero.  Health state and progress
state are deliberately separate — this class only answers "who is up".
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

HEALTHY, FAILED, REPAIRING = 0, 1, 2


class ClusterState:
    """n storage slots over a mutable directed capacity matrix."""

    def __init__(self, caps: np.ndarray, rack_size: int = 0):
        caps = np.asarray(caps, dtype=np.float64)
        if caps.ndim != 2 or caps.shape[0] != caps.shape[1]:
            raise ValueError("caps must be a square (n, n) matrix")
        if (caps < 0).any():
            raise ValueError("link capacities must be non-negative")
        self.caps = caps.copy()
        np.fill_diagonal(self.caps, 0.0)
        self.n = caps.shape[0]
        self.rack_size = rack_size
        self.state = np.zeros(self.n, dtype=np.int8)
        # incremental health bookkeeping: the healthy count and
        # membership only change on fail / complete_repair (start/abort
        # toggle FAILED <-> REPAIRING, both unhealthy), so both are kept
        # as caches invalidated exactly there instead of rescanning
        # ``state`` on every event epoch
        self._num_healthy = self.n
        self._healthy_list: Optional[List[int]] = None
        self._healthy_set: Optional[Set[int]] = None

    # -- placement ----------------------------------------------------------

    def rack_of(self, node: int) -> int:
        return node // self.rack_size if self.rack_size > 0 else 0

    def rack_peers(self, node: int) -> List[int]:
        if self.rack_size <= 0:
            return []
        r = self.rack_of(node)
        return [x for x in range(self.n)
                if x != node and self.rack_of(x) == r]

    # -- health -------------------------------------------------------------

    def healthy_nodes(self) -> List[int]:
        """Ascending healthy slot ids (cached; treat as read-only)."""
        if self._healthy_list is None:
            self._healthy_list = [
                int(x) for x in np.flatnonzero(self.state == HEALTHY)]
        return self._healthy_list

    def healthy_set(self) -> Set[int]:
        """Same membership as :meth:`healthy_nodes`, O(1) lookups — for
        filtering surviving providers and torn-down read endpoints
        (cached; treat as read-only)."""
        if self._healthy_set is None:
            self._healthy_set = set(self.healthy_nodes())
        return self._healthy_set

    @property
    def num_healthy(self) -> int:
        return self._num_healthy

    @property
    def num_unavailable(self) -> int:
        return self.n - self._num_healthy

    def _health_changed(self, delta: int) -> None:
        self._num_healthy += delta
        self._healthy_list = None
        self._healthy_set = None

    def fail(self, node: int) -> None:
        if self.state[node] != HEALTHY:
            raise ValueError(f"node {node} is not healthy")
        self.state[node] = FAILED
        self._health_changed(-1)

    def start_repair(self, node: int) -> None:
        if self.state[node] != FAILED:
            raise ValueError(f"node {node} is not awaiting repair")
        self.state[node] = REPAIRING

    def abort_repair(self, node: int) -> None:
        if self.state[node] != REPAIRING:
            raise ValueError(f"node {node} is not under repair")
        self.state[node] = FAILED

    def complete_repair(self, node: int) -> None:
        if self.state[node] != REPAIRING:
            raise ValueError(f"node {node} is not under repair")
        self.state[node] = HEALTHY
        self._health_changed(+1)
