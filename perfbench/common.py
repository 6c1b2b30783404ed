"""What every loop shares: the run's record, the host clock, the device
trace of a bounded part of the window, and the comparisons that decide
``correct``."""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import statistics
import time
from typing import Any, Dict, List, Optional

now = time.perf_counter


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time against
    its uptime, 10 ms resolution): the set-up includes the interpreter's
    start and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Record:
    """What a run measured.  ``samples`` are lists of host-clock or event
    readings (or counts) by name, ``values`` single numbers, ``trace`` the
    profile of the traced part; the metric readers (``perfbench/metrics``)
    compute from these alone."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = collections.defaultdict(list)
        self.values: Dict[str, float] = {}
        self.checks: List[Check] = []
        self.attempted = 0
        self.failed = 0
        self.trace: Optional[dict] = None
        self.errors: List[str] = []
        self.notes: List[str] = []

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append(Check(name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(c.ok for c in self.checks))


@dataclasses.dataclass
class Context:
    """One run: the cell's configuration and traffic (the parsed files),
    the seed, the window's length, whether this is the traced run, and the
    device."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    record: Record = dataclasses.field(default_factory=Record)
    window_start: Optional[float] = None
    setup_s: Optional[float] = None
    stamps: List[tuple] = dataclasses.field(default_factory=list)

    def stamp(self, name: str) -> None:
        """Note how far set-up has come (seconds since the process
        started, after a synchronize), for the run's log."""
        self.sync()
        try:
            self.stamps.append((name, round(process_age_s(), 2)))
        except (OSError, ValueError, IndexError):
            pass

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """The set-up ends here: the window starts."""
        self.sync()
        try:
            self.setup_s = process_age_s()
        except (OSError, ValueError, IndexError):
            self.setup_s = None
        self.window_start = now()
        return self.window_start

    def window_left(self) -> float:
        return self.seconds - (now() - self.window_start)


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20)[-1]


def mean(values: List[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


def gap(got: float, want: float, scale: Optional[float] = None) -> float:
    """|got - want| against |want|, or against ``scale`` where given."""
    base = abs(want) if scale is None else scale
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / base if base > 0 else abs(got - want)


def worst_leaf_gap(got: List[float], want: List[float],
                   skip: Optional[List[bool]] = None) -> float:
    """The largest gap between two lists of per-leaf norms, each against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger.  Leaves with ``skip`` set are left out."""
    med = statistics.median(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if skip is not None and skip[i]:
            continue
        worst = max(worst, gap(g, w, max(abs(w), med)))
    return worst


# ---------------------------------------------------------------------------
# the device trace of a bounded part of the window
# ---------------------------------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


SHORT_GAP_US = 20.0


def _host_labeller(cpu):
    """A function from a time (profiler us) to what the host was doing
    then: the innermost host operation running, under the benchmark's own
    span (``bench.*``) that contains it."""
    import bisect
    spans = [(n, s, e) for n, s, e in cpu if n.startswith("bench.")]
    ops = sorted((s, e, n) for n, s, e in cpu if not n.startswith("bench."))
    starts = [s for s, _, _ in ops]

    def label(mid):
        span = min(((e - s, n) for n, s, e in spans if s <= mid <= e),
                   default=None)
        inner = None
        i = bisect.bisect_right(starts, mid)
        for s, e, n in reversed(ops[max(0, i - 4000):i]):
            if e >= mid and (inner is None or e - s < inner[0]):
                inner = (e - s, n)
        parts = [p[1] for p in (span, inner) if p is not None]
        return " > ".join(parts) if parts else "no host operation"
    return label


def analyse_profile(prof, window_s: float) -> dict:
    """Device busy seconds (the union of every device interval), the ten
    device operations that took the most time, and the idle gaps summed by
    what the host was doing (gaps under 20 us summed as launch gaps), from
    one ``torch.profiler`` window."""
    import torch
    dev, cpu = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != torch.autograd.DeviceType.CUDA:
            cpu.append((e.name, s, t))
        elif not (e.name.startswith("bench.")
                  or getattr(e, "is_user_annotation", False)):
            dev.append((e.name, s, t))      # not a span's range on the card
    merged = _merge([[s, t] for _, s, t in dev])
    busy_us = sum(t - s for s, t in merged)
    by_op = collections.Counter()
    for name, s, t in dev:
        by_op[name[:120]] += (t - s) / 1e6
    gaps = collections.Counter()
    label = _host_labeller(cpu)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        if b - a < SHORT_GAP_US:
            gaps["launch gaps under 20 us"] += (b - a) / 1e6
        elif b > a:
            gaps[label((a + b) / 2)[:160]] += (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
            "device_events": len(dev)}


@contextlib.contextmanager
def device_trace(ctx: Context, label: str):
    """Profile the block (host and device activity) when this is the traced
    run and no part has been traced yet.  The block is bracketed by
    synchronizes; the profile goes to ``record.trace`` and is read once
    the window has closed (``analyse_profile``)."""
    if not ctx.trace or ctx.record.trace is not None \
            or ctx.device.type != "cuda":
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ctx.sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = now()
        with torch.profiler.record_function(f"bench.{label}"):
            yield
        ctx.sync()
        t1 = now()
    ctx.record.trace = {"prof": prof, "window_s": t1 - t0, "label": label}


def span(label: str):
    """A named host span the device trace can attribute idle gaps to."""
    import torch
    return torch.profiler.record_function(f"bench.{label}")
