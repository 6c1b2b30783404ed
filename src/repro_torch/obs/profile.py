"""Planner profiling: per-stage wall time for ``plan()`` / ``plan_many()``.

A :class:`PlannerProfile` is the ``profile=`` hook the unified planner
API accepts (``repro_torch.core.api``): the dispatcher wraps the whole planner
call in a ``total`` stage, which on the card ends when the device's work
is done, and records call-shape metadata (scheme, resolved engine, batch
size, fallback taken).  The planners registered with ``accepts_profile``
(fr and ftr) receive the profile too: they time their internal stages
(closed form, bisection, candidate generation, local search, final solve,
witness extraction), each ending when the device's work is done, and count
work items (lanes, candidate trees, bisection iterations).

The contract is duck-typed on purpose: the planning core never imports
this module — it calls ``profile.stage(name)`` (a context manager),
``profile.count(name, n)`` and ``profile.note(**kw)`` on whatever object
the caller passed, and skips all of it when ``profile is None`` (the
zero-overhead default).  ``summary()`` renders the accumulated numbers
as a JSON-ready dict, with the same keys as the reference's.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List


class PlannerProfile:
    """Accumulates per-stage wall time, counters and call metadata.

    Reusable across calls: a second ``plan_many`` with the same profile
    adds to the same stages (mean-of-N timing).  Not thread-safe.
    """

    def __init__(self) -> None:
        # stage name -> [calls, total seconds], in first-seen order
        self._stages: Dict[str, List[float]] = {}
        self.counters: Dict[str, int] = {}
        self.meta: Dict[str, Any] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time one stage; nests and repeats accumulate."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, calls: int = 1) -> None:
        cell = self._stages.setdefault(name, [0, 0.0])
        cell[0] += calls
        cell[1] += seconds

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def note(self, **kw: Any) -> None:
        """Attach call-shape metadata (last write wins per key)."""
        self.meta.update(kw)

    def summary(self) -> dict:
        """JSON-ready view: stages (calls + milliseconds), counters, meta."""
        return {
            "stages": {name: {"calls": int(calls), "ms": sec * 1e3}
                       for name, (calls, sec) in self._stages.items()},
            "counters": dict(self.counters),
            "meta": dict(self.meta),
        }
