"""Spans and counters inside the program, on ``torch.profiler``'s clock.

``span(name, args)`` marks host work at a layer boundary (a plan, a
planner stage, a repair, a GF(2^8) product, a train step's replay, a
checkpoint save).  It is on exactly while ``torch.profiler`` records:

* **off**, a span costs one test of ``torch.autograd.profiler.
  _is_profiler_enabled``, the module flag the profiler sets when it starts
  and clears when it stops (the test torch's own dynamo makes; a plain
  attribute read, cheaper than the C call ``torch._C._autograd.
  _profiler_enabled()``), and returns a shared no-op context;
* **on**, it enters ``torch.profiler.record_function(name, args)``, so it
  lies on the device trace's own clock, nested under whatever span is
  open, and it adds to an in-memory tally per name: calls, host seconds,
  and self seconds (its time less its child spans').

The full record of the spans is the profiler's own: ``export_chrome_trace``
writes them beside the device timeline.  The tallies cover what was
profiled and only that.

``count(name, n)`` adds to a total that is always kept (a dict add) and,
while the profiler records, to a traced total beside it.  The GF(2^8)
kernel's dispatcher hands ``product`` the CUDA events it records around
each launch while profiling, with the product's shape.

``summary()`` returns a JSON-ready view; ``reset()`` clears it.  The state
is the process's, like the profiler's; spans assume one thread opens them.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_totals: Dict[str, int] = {}
_traced: Dict[str, int] = {}
_spans: Dict[str, List[float]] = {}          # name -> [calls, s, self s]
_open: List["_Span"] = []
_pending: List[tuple] = []                   # (key, start, end) events
_products: Dict[Tuple[int, int, int, str], List[float]] = {}  # [calls, s]


def on() -> bool:
    """Whether ``torch.profiler`` is recording (spans are on)."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str, args: Optional[Mapping]):
        self.name = name
        self.rf = torch.profiler.record_function(
            name, None if args is None else
            ", ".join(f"{k}={v}" for k, v in args.items()))

    def __enter__(self) -> "_Span":
        self.rf.__enter__()
        self.child = 0.0
        _open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        took = time.perf_counter() - self.t0
        _open.pop()
        if _open:
            _open[-1].child += took
        tally = _spans.setdefault(self.name, [0, 0.0, 0.0])
        tally[0] += 1
        tally[1] += took
        tally[2] += took - self.child
        self.rf.__exit__(*exc)


def span(name: str, args: Optional[Mapping] = None):
    """A context manager marking the host work inside it as ``name``
    (``args``, a mapping, is formatted into the profiler's event only when
    the span is on)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its traced total while the
    profiler records)."""
    _totals[name] = _totals.get(name, 0) + n
    if _profiler._is_profiler_enabled:
        _traced[name] = _traced.get(name, 0) + n


def total(name: str) -> int:
    """The counter's total since the last ``reset``."""
    return _totals.get(name, 0)


def product(shape: Tuple[int, int, int], variant: str,
            start: torch.cuda.Event, end: torch.cuda.Event) -> None:
    """Keep one GF(2^8) product's launch events with its (M, K, N) and
    variant; read at ``summary``, after the device has run it."""
    _pending.append(((*shape, variant), start, end))


def _resolve() -> None:
    for key, start, end in _pending:
        end.synchronize()
        cell = _products.setdefault(key, [0, 0.0])
        cell[0] += 1
        cell[1] += start.elapsed_time(end) / 1e3
    _pending.clear()


def summary() -> dict:
    """JSON-ready: ``spans`` (calls, ms, self_ms), ``counters`` (total,
    traced) and ``products`` (shape, variant, calls, ms of device time)."""
    _resolve()
    return {
        "spans": {name: {"calls": int(c), "ms": s * 1e3, "self_ms": own * 1e3}
                  for name, (c, s, own) in _spans.items()},
        "counters": {name: {"total": n, "traced": _traced.get(name, 0)}
                     for name, n in _totals.items()},
        "products": [{"shape": [m, k, n], "variant": v, "calls": int(c),
                      "ms": s * 1e3}
                     for (m, k, n, v), (c, s) in _products.items()],
    }


def reset() -> None:
    """Clear every tally, total and product."""
    for store in (_totals, _traced, _spans, _pending, _products):
        store.clear()
