"""Event primitives for the fleet simulator.

The simulator distinguishes *exogenous* events — scheduled ahead of time on
a heap (failures, capacity shocks, degraded-read arrivals/departures, end of
horizon) — from repair *completions*, which are never enqueued: a repair's
finish time moves every time link shares change, so completions are derived
fresh each iteration from (remaining work, current nominal duration).  This
sidesteps the classic stale-heap-entry problem of processor-sharing
simulations entirely.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional, Tuple

# Event kinds (exogenous only — completions are derived, see module doc).
FAILURE = "failure"
CAPACITY_SHOCK = "capacity_shock"
READ_ARRIVAL = "read_arrival"
READ_DEPARTURE = "read_departure"

# Robustness family.  DEGRADE multiplies a live node's *outgoing*
# link rates by a factor in [0, 1) without failing the host — factor 0.0 is
# a full stall, the fault class the provider-loss abort path cannot see;
# RECOVER restores the node (payload carries a generation counter so a
# re-degrade supersedes a stale recovery).  ESTIMATE_REFRESH re-snapshots
# the planner's believed capacity matrix; WATCHDOG is the periodic progress
# check that drives retry/backoff mitigation.
DEGRADE = "degrade"
RECOVER = "recover"
ESTIMATE_REFRESH = "estimate_refresh"
WATCHDOG = "watchdog"

# Coded data plane: an open-loop read arrival replayed from a
# ``ReadTrace`` — unlike READ_ARRIVAL these fire on the trace's own clock
# whether or not a slot is down (payload: none; the next trace line is
# pulled lazily when this one fires).
TRACE_READ = "trace_read"


@dataclasses.dataclass(frozen=True)
class Event:
    """A scheduled exogenous event.

    ``payload`` is kind-specific: the victim node for an injected FAILURE
    (or None for a Poisson draw resolved at fire time), the read id for
    READ_DEPARTURE.
    """

    time: float
    kind: str
    payload: Optional[Tuple] = None


class EventQueue:
    """Min-heap of events with a deterministic FIFO tie-break.

    Events at equal timestamps pop in insertion order (a monotone sequence
    number breaks ties), so a seeded simulation is reproducible regardless
    of float coincidences.
    """

    def __init__(self) -> None:
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.time, next(self._seq), ev))

    def peek_time(self) -> float:
        return self._heap[0][0] if self._heap else float("inf")

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)
