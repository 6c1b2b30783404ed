"""Fleet-level metrics: what single-repair Monte Carlo cannot measure.

Everything here is accumulated *online* during the event loop so the
summary is O(1) memory in simulated time except the per-repair samples
needed for percentiles.

* backlog — queued + active repairs, integrated time-weighted, plus the
  full step timeline for plotting;
* regeneration time under contention — completion minus start, p50/p99;
* window of vulnerability — per repaired slot, failure to completion (the
  interval the system runs with that slot's redundancy missing), plus the
  fraction of time *any* slot was unavailable;
* MTTDL estimate — the Dimakis et al. (0803.0632) reliability question.
  Counting actual ruin events (> n-k slots down) is hopeless at sane
  failure rates, so alongside the raw count we integrate the conditional
  ruin intensity: while exactly n-k slots are down (one failure from
  loss), the instantaneous loss rate is lambda * healthy(t).  Integrated
  over the run this gives the expected number of loss events, and
  MTTDL ~= duration / E[events] — a standard rare-event estimator that
  stays finite and seeded-deterministic.  The intensity accrues for every
  state at or past the boundary (``unavailable >= n - k``), not just at
  equality — deep-failure excursions keep losing data;
* repair-lifecycle counters — migrations, carryover vs cold aborts,
  and the work-saved fraction (banked blocks credited at re-admissions and
  migrations as a share of the plans' totals);
* plan-vs-reality — the plan-error distribution (realized
  duration of each completed (re)plan segment against the ETA predicted at
  (re)plan time under the *believed* capacities; positive = late), plus
  watchdog counters: repairs flagged lagging, in-place rescue replans,
  straggler evictions, give-ups (retry budget exhausted), degraded-d
  admissions (d' < d helpers), and injected degrade events.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


# Every monotone counter attribute and the ``summary()`` key it lands
# under — the round-trip contract tests/test_metrics.py pins (a counter
# added without a summary key, or renamed on one side only, fails there).
COUNTER_SUMMARY_KEYS: Dict[str, str] = {
    "completed": "completed",
    "aborted": "aborted",
    "carryover_aborts": "carryover_aborts",
    "cold_aborts": "cold_aborts",
    "migrations": "migrations",
    "work_saved": "work_saved_blocks",
    "data_loss_events": "data_loss_events",
    "watchdog_flags": "watchdog_flags",
    "watchdog_replans": "watchdog_replans",
    "evictions": "evictions",
    "watchdog_giveups": "watchdog_giveups",
    "degraded_admissions": "degraded_admissions",
    "degrade_events": "degrade_events",
    "max_backlog": "max_backlog",
    # coded data plane — these summary keys are emitted only
    # when the dataplane flag is set (any dataplane hook sets it), so the
    # default-path summaries, and with them the fleet golden, are unchanged
    "reads_completed": "reads_completed",
    "reads_dropped": "reads_dropped",
    "reads_torn_down": "reads_torn_down",
    "decode_checks": "decode_checks",
    "decode_failures": "decode_failures",
    "repair_bytes": "repair_bytes",
    "read_bytes": "read_bytes",
}


@dataclasses.dataclass
class FleetMetrics:
    """Online accumulator; call ``observe`` on every state change."""

    n: int
    k: int
    failure_rate: float

    now: float = 0.0
    backlog: int = 0
    unavailable: int = 0

    backlog_integral: float = 0.0
    unavail_time: float = 0.0          # time with >= 1 slot unavailable
    at_risk_time: float = 0.0          # time with exactly n-k slots down
    expected_losses: float = 0.0       # integral of conditional ruin rate
    max_backlog: int = 0

    completed: int = 0
    aborted: int = 0
    carryover_aborts: int = 0          # aborts that kept banked blocks
    cold_aborts: int = 0               # aborts that restarted from zero
    migrations: int = 0                # accepted in-flight plan migrations
    # blocks credited instead of re-sent, summed per (re)plan event: every
    # re-plan would otherwise restart its plan from zero, so a bank that
    # survives several re-plans is (correctly) credited at each of them —
    # this is a per-event demand discount, not a count of unique blocks
    work_saved: float = 0.0
    data_loss_events: int = 0

    # -- plan-vs-reality robustness -------------------------------
    watchdog_flags: int = 0            # repairs flagged lagging/stalled
    watchdog_replans: int = 0          # accepted in-place rescue replans
    evictions: int = 0                 # straggling providers evicted
    watchdog_giveups: int = 0          # retry budget exhausted
    degraded_admissions: int = 0       # repairs admitted with d' < d
    degrade_events: int = 0            # injected + Markov brownouts

    # -- coded data plane ----------------------------------------
    dataplane: bool = False            # gates the dataplane_* summary keys;
    #                                    set by the simulator / any hook below
    reads_completed: int = 0           # fragment-transfer reads delivered
    reads_dropped: int = 0             # trace arrivals with < fanin+1 healthy
    reads_torn_down: int = 0           # in-flight reads killed by a failure
    decode_checks: int = 0             # post-repair can_reconstruct checks
    decode_failures: int = 0           # checks where k nodes could NOT decode
    repair_bytes: float = 0.0          # coded repair bytes on the wire
    read_bytes: float = 0.0            # fragment read bytes on the wire

    plan_errors: List[float] = dataclasses.field(default_factory=list)
    credit_fractions: List[float] = dataclasses.field(default_factory=list)
    regen_times: List[float] = dataclasses.field(default_factory=list)
    vulnerability_windows: List[float] = dataclasses.field(
        default_factory=list)
    wait_times: List[float] = dataclasses.field(default_factory=list)
    read_latencies: List[float] = dataclasses.field(default_factory=list)
    backlog_timeline: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)

    def observe(self, t: float, backlog: int, unavailable: int) -> None:
        """Advance the clock to ``t`` integrating the previous state, then
        record the new (backlog, unavailable) levels."""
        dt = t - self.now
        if dt < 0:
            raise ValueError(f"time ran backwards: {self.now} -> {t}")
        if dt > 0:
            self.backlog_integral += self.backlog * dt
            if self.unavailable > 0:
                self.unavail_time += dt
            if self.unavailable == self.n - self.k:
                self.at_risk_time += dt
            if self.unavailable >= self.n - self.k:
                # conditional ruin intensity: every further failure is a
                # loss event, *including* while already past the boundary —
                # integrating only at equality would stop accruing when a
                # run dips deeper and bias the MTTDL estimate high
                healthy = self.n - self.unavailable
                self.expected_losses += self.failure_rate * healthy * dt
        self.now = t
        if backlog != self.backlog or not self.backlog_timeline:
            self.backlog_timeline.append((t, backlog))
        self.backlog = backlog
        self.unavailable = unavailable
        self.max_backlog = max(self.max_backlog, backlog)

    def on_complete(self, fail_time: float, start_time: float,
                    end_time: float, plan_t0: Optional[float] = None,
                    predicted: Optional[float] = None) -> None:
        self.completed += 1
        self.regen_times.append(end_time - start_time)
        self.wait_times.append(start_time - fail_time)
        self.vulnerability_windows.append(end_time - fail_time)
        # plan error: the realized duration of the final (re)plan segment
        # against its believed-capacity prediction — relative, so 0 means
        # the plan's map matched the territory and +1 means it took twice
        # as long as predicted
        if (plan_t0 is not None and predicted is not None
                and math.isfinite(predicted) and predicted > 0):
            self.plan_errors.append((end_time - plan_t0) / predicted - 1.0)

    def on_watchdog_flag(self) -> None:
        self.watchdog_flags += 1

    def on_watchdog_replan(self, saved: float, planned: float) -> None:
        """A lagging repair was rescued in place by a credited replan."""
        self.watchdog_replans += 1
        self.on_carryover(saved, planned)

    def on_eviction(self) -> None:
        self.evictions += 1

    def on_watchdog_giveup(self) -> None:
        self.watchdog_giveups += 1

    def on_degraded_admission(self) -> None:
        self.degraded_admissions += 1

    def on_degrade(self) -> None:
        self.degrade_events += 1

    def on_abort(self, carryover: bool = False) -> None:
        self.aborted += 1
        if carryover:
            self.carryover_aborts += 1
        else:
            self.cold_aborts += 1

    def on_carryover(self, saved: float, planned: float) -> None:
        """Banked-work credit applied at a (re)plan event: ``saved`` of the
        plan's ``planned`` total blocks were already received and are not
        re-sent (see the ``work_saved`` field note on summing)."""
        self.work_saved += saved
        self.credit_fractions.append(saved / planned if planned > 0 else 0.0)

    def on_migration(self, saved: float, planned: float) -> None:
        """An in-flight repair migrated to a new plan, with credit."""
        self.migrations += 1
        self.on_carryover(saved, planned)

    def on_data_loss(self) -> None:
        self.data_loss_events += 1

    # -- coded data plane ----------------------------------------

    def on_read_complete(self, latency: float, nbytes: float) -> None:
        """A fragment-transfer read delivered all its bytes."""
        self.dataplane = True
        self.reads_completed += 1
        self.read_latencies.append(latency)
        self.read_bytes += nbytes

    def on_read_drop(self) -> None:
        """A trace arrival found fewer than fanin + 1 healthy nodes."""
        self.dataplane = True
        self.reads_dropped += 1

    def on_read_teardown(self, nbytes: float) -> None:
        """A failure killed an in-flight read; ``nbytes`` already crossed
        the wire and still count as read traffic."""
        self.dataplane = True
        self.reads_torn_down += 1
        self.read_bytes += nbytes

    def on_repair_bytes(self, nbytes: float) -> None:
        """A repair segment ended, having moved ``nbytes`` of coded blocks."""
        self.dataplane = True
        self.repair_bytes += nbytes

    def on_decode_check(self, ok: bool) -> None:
        """Post-repair decode verification via ``rlnc.can_reconstruct``."""
        self.dataplane = True
        self.decode_checks += 1
        if not ok:
            self.decode_failures += 1

    # -- summary ------------------------------------------------------------

    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def summary(self) -> Dict[str, float]:
        dur = max(self.now, 1e-300)
        mttdl = (dur / self.expected_losses
                 if self.expected_losses > 0 else math.inf)
        out = {
            "duration": self.now,
            "completed": self.completed,
            "aborted": self.aborted,
            "carryover_aborts": self.carryover_aborts,
            "cold_aborts": self.cold_aborts,
            "migrations": self.migrations,
            "work_saved_blocks": self.work_saved,
            "work_saved_fraction": (float(np.mean(self.credit_fractions))
                                    if self.credit_fractions else 0.0),
            "mean_backlog": self.backlog_integral / dur,
            "max_backlog": self.max_backlog,
            "regen_p50": self._pct(self.regen_times, 50),
            "regen_p99": self._pct(self.regen_times, 99),
            "regen_mean": (float(np.mean(self.regen_times))
                           if self.regen_times else 0.0),
            "wait_p99": self._pct(self.wait_times, 99),
            "vulnerability_p99": self._pct(self.vulnerability_windows, 99),
            "unavail_fraction": self.unavail_time / dur,
            "at_risk_fraction": self.at_risk_time / dur,
            "data_loss_events": self.data_loss_events,
            "expected_data_losses": self.expected_losses,
            "mttdl_estimate": mttdl,
            "watchdog_flags": self.watchdog_flags,
            "watchdog_replans": self.watchdog_replans,
            "evictions": self.evictions,
            "watchdog_giveups": self.watchdog_giveups,
            "degraded_admissions": self.degraded_admissions,
            "degrade_events": self.degrade_events,
            "plan_err_mean": (float(np.mean(self.plan_errors))
                              if self.plan_errors else 0.0),
            "plan_err_p50": self._pct(self.plan_errors, 50),
            "plan_err_p99": self._pct(self.plan_errors, 99),
        }
        if self.dataplane:
            out.update({
                "reads_completed": self.reads_completed,
                "reads_dropped": self.reads_dropped,
                "reads_torn_down": self.reads_torn_down,
                "decode_checks": self.decode_checks,
                "decode_failures": self.decode_failures,
                "repair_bytes": self.repair_bytes,
                "read_bytes": self.read_bytes,
                "read_p50": self._pct(self.read_latencies, 50),
                "read_p99": self._pct(self.read_latencies, 99),
                "read_mean": (float(np.mean(self.read_latencies))
                              if self.read_latencies else 0.0),
            })
        return out
