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

Two more kinds serve a step that runs as a CUDA graph, whose replay runs
no Python and so opens no span:

* ``count_on_device(name, n)`` adds a 0-d integer tensor to a total that
  stays on the device (``device_total`` reads it on the host, after the
  work): a replay adds again, and the step reads nothing on the host;
* ``timed(name, fn, x)``, while ``time_device(True)`` is in force, brackets
  ``fn(x)``'s forward with CUDA events and its backward with two more,
  recorded by autograd when the gradient reaches its output and when it
  leaves its input.  The events are ``external``, so a capture takes them
  into the graph and every replay records them again; ``device_ms``
  sums the kept pairs (the forward's at once, the backward's once it has
  run), ``clear_device_times`` drops them (before a capture, so that
  the pairs are the graph's).

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
_device: Dict[str, torch.Tensor] = {}        # name -> 0-d int64 total
_times: Dict[str, List[tuple]] = {}          # name -> [(start, end), ...]
_alive: List["torch.cuda.Event"] = []        # every event since the clear
_timing = False


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


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the 0-d integer tensor ``n`` to the device total ``name``, with
    no host read.  The total is made at its first call, which may not lie
    inside a CUDA graph's capture (the graph's memory is not the
    total's): an eager step comes first."""
    t = _device.get(name)
    if t is None or t.device != n.device:
        if n.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} first counted "
                               f"inside a CUDA graph's capture")
        t = _device[name] = torch.zeros((), dtype=torch.int64,
                                        device=n.device)
    t.add_(n)


def device_total(name: str) -> int:
    """The device total's value (a host read: after the work)."""
    t = _device.get(name)
    return 0 if t is None else int(t)


def time_device(enabled: bool) -> None:
    """Whether ``timed`` records CUDA events (decided when the work is
    enqueued or captured)."""
    global _timing
    _timing = bool(enabled)


class _Mark(torch.autograd.Function):
    """The identity, recording a CUDA event when its gradient passes; the
    input's mark also keeps the backward's pair of events.  The output's
    mark saves an empty tensor, so that under remat
    (``torch.utils.checkpoint``) the region is recomputed before its event
    is recorded, and the recomputation (timed as a forward) stays out of
    the backward's pair."""

    @staticmethod
    def forward(ctx, x, name, start, end):
        ctx.name, ctx.start, ctx.end = name, start, end
        if start is None:
            ctx.save_for_backward(x.new_empty(0))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.start is None:           # the output's mark: the start
            ctx.saved_tensors
            ctx.end.record()
        else:                           # the input's: the end, and keep
            ctx.end.record()
            _times.setdefault(ctx.name, []).append((ctx.start, ctx.end))
        return g, None, None, None


def timed(name: str, fn, x: torch.Tensor):
    """``fn(x)`` (a tensor or a tuple whose first item is the region's
    output), its device time kept under ``name`` while ``time_device`` is
    on and ``x`` lies on CUDA: a pair of events around the forward, and,
    where ``x`` needs a gradient, a pair around the backward."""
    if not _timing or x.device.type != "cuda":
        return fn(x)

    def event():
        # kept until ``clear_device_times``: a graph's capture may hold an
        # event that no pair keeps (a recomputation that remat stops early),
        # and an event freed before the capture ends breaks it
        ev = torch.cuda.Event(enable_timing=True, external=True)
        _alive.append(ev)
        return ev
    back = x.requires_grad and torch.is_grad_enabled()
    if back:
        b0, b1 = event(), event()
        x = _Mark.apply(x, name, b0, b1)
    f0, f1 = event(), event()
    f0.record()
    out = fn(x)
    f1.record()
    _times.setdefault(name, []).append((f0, f1))
    if back:
        first = out[0] if isinstance(out, tuple) else out
        first = _Mark.apply(first, name, None, b0)
        out = (first,) + tuple(out[1:]) if isinstance(out, tuple) else first
    return out


def device_ms(name: str) -> float:
    """Milliseconds of every kept pair of ``name``'s events, summed (after
    the work has run: a host read)."""
    total = 0.0
    for a, b in _times.get(name, []):
        b.synchronize()
        total += a.elapsed_time(b)
    return total


def clear_device_times() -> None:
    """Drop the kept events (a graph captured after this keeps its own;
    one captured before must have been released)."""
    _times.clear()
    _alive.clear()


def reset() -> None:
    """Clear every tally, total, product, device total and event."""
    for store in (_totals, _traced, _spans, _pending, _products, _device,
                  _times, _alive):
        store.clear()
