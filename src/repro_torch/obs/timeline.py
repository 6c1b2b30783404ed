"""Link occupancy timelines, integrated online.

``LinkShareModel`` (``fleet/sharing.py``) calls :meth:`LinkUsageTracer.
on_users` on every per-link occupancy change (acquire/release of repairs
and degraded reads).  The tracer integrates, per directed physical link:

* ``busy_time`` — seconds with >= 1 occupant;
* ``user_seconds`` — the time integral of the occupant count (two flows
  for 5 s contribute 10), the contention measure;
* ``max_users`` — the peak occupant count.

These aggregates are exact regardless of the flight recorder's ring
buffer (they are accumulated here, not reconstructed from events), which
is what makes the conservation check in ``benchmarks/check_trace.py``
valid on long runs: every active repair occupies at least one link for
its whole active window, so ``total user-seconds >= sum of realized
regeneration times``.

When a :class:`~repro_torch.obs.trace.FlightRecorder` is attached, every
change is also emitted as a ``link_users`` event — the Chrome export
renders those as per-link counter tracks.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .trace import FlightRecorder

Link = Tuple[int, int]


class LinkUsageTracer:
    """Online per-link utilization/contention integrator.

    ``clock`` returns the current simulated time (the simulator passes
    ``lambda: self.now``); ``recorder`` optionally mirrors every change
    into the flight recorder.
    """

    def __init__(self, clock: Callable[[], float],
                 recorder: Optional[FlightRecorder] = None):
        self.clock = clock
        self.recorder = recorder
        self.busy_time: Dict[Link, float] = {}
        self.user_seconds: Dict[Link, float] = {}
        self.max_users: Dict[Link, int] = {}
        self._users: Dict[Link, int] = {}
        self._since: Dict[Link, float] = {}

    def _integrate(self, link: Link, t: float) -> None:
        prev = self._users.get(link, 0)
        if prev > 0:
            dt = t - self._since[link]
            if dt > 0:
                self.busy_time[link] = self.busy_time.get(link, 0.0) + dt
                self.user_seconds[link] = (self.user_seconds.get(link, 0.0)
                                           + prev * dt)

    def on_users(self, link: Link, users: int) -> None:
        """The occupant count of ``link`` just changed to ``users``."""
        t = float(self.clock())
        self._integrate(link, t)
        if users > 0:
            self._users[link] = users
            self._since[link] = t
            if users > self.max_users.get(link, 0):
                self.max_users[link] = users
        else:
            self._users.pop(link, None)
            self._since.pop(link, None)
        if self.recorder is not None:
            self.recorder.emit(t, "link_users", src=link[0], dst=link[1],
                               users=users)

    def finish(self, t_end: float) -> None:
        """Close the books at ``t_end``: integrate every still-occupied
        link up to the horizon (idempotent — a second call adds zero)."""
        for link in list(self._users):
            self._integrate(link, t_end)
            self._since[link] = t_end

    def snapshot(self) -> dict:
        """JSON-ready aggregate view (stringified ``"src->dst"`` keys)."""
        links = {}
        for link in sorted(set(self.busy_time) | set(self.max_users)):
            links[f"{link[0]}->{link[1]}"] = {
                "busy_time": self.busy_time.get(link, 0.0),
                "user_seconds": self.user_seconds.get(link, 0.0),
                "max_users": self.max_users.get(link, 0),
            }
        return {
            "links": links,
            "total_busy_time": sum(self.busy_time.values()),
            "total_user_seconds": sum(self.user_seconds.values()),
        }
