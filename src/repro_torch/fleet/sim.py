"""Discrete-event fleet simulator: concurrent regenerations over shared links.

The loop advances between events; repairs progress as fluid flows whose
rates are set by the fair-share link model (``sharing.py``).  Exogenous
events (failures, capacity shocks, degraded reads) live on a heap; repair
completions are *derived* each iteration from (remaining work x current
nominal duration), so share changes mid-repair are handled exactly — a
regeneration's duration emerges from contention instead of being read off
its plan.

Per event epoch, every repair that can start (queued slot, >= d healthy
providers, concurrency budget left) is planned in ONE call to the policy
with a stacked tensor of residual-capacity overlays — this is where the
batched planning engine runs in throughput mode (many concurrent
repairs per call) rather than Monte-Carlo mode.

Failure model details:

* Poisson failures at ``failure_rate`` per healthy node; the aggregate
  exponential clock is re-drawn whenever the healthy population changes
  (memorylessness makes this exact for the Markov process).
* A failed slot's repair regenerates onto a replacement host in the same
  slot, so the capacity matrix is stable across repairs.
* If an active repair loses a provider to a new failure, it aborts: its
  links are released and the slot is requeued with its original failure
  time (the vulnerability window keeps accruing).  With
  ``Scenario.carryover`` on, the blocks already received from surviving
  providers travel with the queued slot as a per-link bank; re-admission
  keeps the surviving providers and credits the bank against the new
  plan's edge demands, so only the missing flows are re-transferred.
  With it off (default), the work is lost — the default dynamics,
  bitwise.
* With ``Scenario.migration`` on, every capacity-shock and provider-loss
  epoch offers the in-flight repairs a re-plan through
  ``RepairPolicy.replan`` (one batched call, same engine path as
  admission); a proposal is accepted only if its banked-credited ETA under
  self-excluded shares beats the current one, so migration never extends a
  repair's expected finish at decision time.
* Data-loss accounting: every failure that leaves fewer than k healthy
  slots is a loss event; ``FleetMetrics`` additionally integrates the
  conditional ruin intensity for an MTTDL estimate that works at sane
  failure rates.

Plan-vs-reality robustness, all OFF by default:

* **Estimate error** (``Scenario.estimate_noise`` / ``estimate_refresh_
  period``): policies plan against a *believed* capacity matrix — a noisy,
  periodically-refreshed snapshot of the true effective capacities — while
  flows progress at true rates.  Predicted and realized ETAs diverge; the
  metrics record the plan-error distribution.
* **Straggler/stall injection** (``degrade_rate`` + Markov recovery, or
  deterministic ``degradations``): a live node's outgoing link rates are
  multiplied by a factor in [0, 1) without failing the host — invisible to
  the provider-loss abort path *and* to the believed matrix until the next
  estimate refresh (when estimates are off, the fresh believed view models
  plan-time capacities only: brownouts are data-plane faults monitoring
  never reports).
* **Watchdog + retry/backoff + graceful degradation**
  (``watchdog_period`` > 0): every period, each repair's banked progress
  is compared against its plan-predicted trajectory.  A repair below
  ``1/watchdog_lag`` of schedule (or outright stalled) gets escalating
  mitigation — first a credited in-place replan over the current believed
  capacities, then eviction of the straggling provider (bottleneck-link
  source) with the banked blocks carried over and a fresh helper drawn
  under exponential backoff, up to ``watchdog_retries`` times.  With
  ``degraded_d`` on, a repair that cannot find d healthy helpers is
  admitted with d' in [k, d) helpers (functional repair is sound for any
  d >= k, Dimakis et al. 0803.0632) instead of queueing forever.

Observability: with ``Scenario.trace`` on the simulator owns a
``repro_torch.obs.FlightRecorder`` and emits the repair-lifecycle vocabulary —
``repair_queued`` (reason fail|abort|evict) / ``repair_admitted`` /
``repair_deferred`` / ``repair_abort`` / ``repair_evicted`` /
``repair_replan`` (kind migration|watchdog) / ``repair_complete`` plus
``watchdog_flag`` / ``watchdog_giveup``, node events (``node_fail`` /
``node_repaired`` / ``node_degrade`` / ``node_recover``), and
``data_loss`` / ``capacity_shock`` / ``estimate_refresh`` — while the
share model streams per-link occupancy into a ``LinkUsageTracer``.
Every emission site is guarded and none touches an rng stream, so traced
and untraced runs are bitwise identical (pinned by the goldens and
tests/test_torch_obs.py): tracing is observation, not perturbation.

Coded data plane, OFF by default: with ``Scenario.dataplane``
on, degraded reads become real fragment transfers (``params.alpha``
blocks per source) progressing through the same fair-share fluid model
as repairs — ``read_duration`` is ignored — and every completed repair
replays its plan on an RLNC-coded store (``repro_torch.storage.simulator``)
so the regenerated blocks can be decode-verified.  Per-link repair/read
bytes are ledgered in ``fleet.dataplane.DataPlane``; an optional
``Scenario.read_trace`` adds an open-loop arrival process on the
dedicated ``"data"`` rng stream.  Off, no coded store is allocated, no
extra rng is drawn, and every new code path is behind a ``dataplane is
None`` guard — the default instruction stream is unchanged (pinned by
the fleet golden).

Determinism: one root ``seed`` spawns named child streams (capacities,
failures, providers, reads, shocks, estimates, degrades, data plane) via
``np.random.default_rng([seed, stream])``, and all same-time events have
fixed precedence (repair completions, then read completions, then heap
order, then the Poisson failure clock, then the Poisson degrade clock),
so a run is bitwise reproducible.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core import CodeParams
from ..device import DeviceLike, resolve_device
from ..obs import FlightRecorder, LinkUsageTracer

from .cluster import ClusterState
from .events import (CAPACITY_SHOCK, DEGRADE, ESTIMATE_REFRESH, Event,
                     EventQueue, FAILURE, READ_ARRIVAL, READ_DEPARTURE,
                     RECOVER, TRACE_READ, WATCHDOG)
from .metrics import FleetMetrics
from .policy import RepairPolicy
from .scenario import Scenario
from .sharing import (ActiveRepair, Link, LinkShareModel, apply_credit,
                      plan_links)

_STREAMS = {"caps": 0, "fail": 1, "prov": 2, "read": 3, "shock": 4,
            "est": 5, "degrade": 6, "data": 7}


class QueuedRepair(NamedTuple):
    """A slot awaiting (re-)admission.

    ``bank`` carries blocks already received per physical link when a
    carryover abort requeued the slot (None on a fresh failure);
    ``survivors`` are the aborted plan's still-useful providers, kept at
    re-admission so the banked links actually reappear in the new plan.
    ``avoid``/``retries``/``next_check`` travel with a slot the watchdog
    evicted a straggling provider from: evicted providers are not re-drawn
    while alternatives exist, the mitigation budget persists across the
    requeue, and the backoff clock is not reset by re-admission.
    ``rid`` is the flight-recorder repair id, assigned at the
    original failure and carried through every abort/eviction requeue so
    one lifecycle is one span tree; -1 when tracing is off.
    """

    fail_time: float
    node: int
    bank: Optional[Dict[Link, float]] = None
    survivors: Tuple[int, ...] = ()
    avoid: Tuple[int, ...] = ()
    retries: int = 0
    next_check: float = 0.0
    rid: int = -1


class FleetSimulator:
    """Simulate ``scenario`` under ``policy`` for one (n, k, d) code.

    ``device`` is where the policy plans and the data plane's store lives:
    the card unless ``device="cpu"`` is named.  Without CUDA and without
    ``device="cpu"`` the constructor raises ``RuntimeError``.
    """

    def __init__(self, scenario: Scenario, policy: RepairPolicy,
                 params: CodeParams, seed: int = 0,
                 check_shares: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        if params.d > scenario.num_nodes - 1:
            raise ValueError(
                f"d={params.d} providers need a cluster of > d nodes, "
                f"got {scenario.num_nodes}")
        self.scenario = scenario
        self.policy = policy
        self.params = params
        self.seed = seed
        self.rng = {name: np.random.default_rng([seed, sid])
                    for name, sid in _STREAMS.items()}

        n = scenario.num_nodes
        base = np.asarray(scenario.capacity_model(self.rng["caps"], n),
                          dtype=np.float64)
        self.cluster = ClusterState(base, rack_size=scenario.rack_size)
        self.caps_base = self.cluster.caps.copy()
        # check_shares=True shadows every incremental share recompute with
        # the full-rescan oracle and asserts bitwise equality (slow; for
        # tests/debugging only)
        self.shares = LinkShareModel(self.cluster.caps, check=check_shares)

        # -- flight recorder: allocated only when asked for, and
        #    every emission site is guarded, so the default path runs the
        #    exact pre-observability instruction stream (no rng touched)
        self._rid_seq = 0
        self.recorder: Optional[FlightRecorder] = None
        self.link_tracer: Optional[LinkUsageTracer] = None
        if scenario.trace:
            self.recorder = FlightRecorder(
                capacity=scenario.trace_capacity,
                meta={"seed": seed, "num_nodes": n, "k": params.k,
                      "d": params.d, "duration": scenario.duration,
                      "policy": getattr(policy, "name", "?")})
            self.link_tracer = LinkUsageTracer(clock=lambda: self.now,
                                               recorder=self.recorder)
            self.shares.tracer = self.link_tracer

        self.now = 0.0
        self.queue: List[QueuedRepair] = []         # fail-time-ordered FIFO
        self.active: List[ActiveRepair] = []        # kept in start order
        self.reads: dict = {}
        self._reads_at: Dict[int, set] = {}     # node -> rids touching it
        self._indexed_rids: set = set()         # rids present in _reads_at
        self._read_seq = 0
        self._replan_pending = False
        self.loop_events = 0        # event epochs processed (perf metric)
        # (next event time, completion time, completion index, heap time,
        # read-completion time, read index) cached by _refresh_pending
        # after every step — this is what the lockstep ensemble loop
        # reads through next_event_time()
        self._pending: Tuple[float, float, int, float, float, int] = \
            (math.inf, math.inf, -1, math.inf, math.inf, -1)
        self._started = False

        # -- straggler/stall injection: per-node outgoing-rate multipliers.
        #    None (no degrade machinery configured) keeps the share model's
        #    arithmetic bitwise identical to the pre-robustness path.
        self.degrade: Optional[np.ndarray] = None
        self._degrade_gen = [0] * n      # stale-RECOVER supersession
        if scenario.degrade_rate > 0 or scenario.degradations:
            self.degrade = np.ones(n, dtype=np.float64)
            self.shares.out_mult = self.degrade

        # -- estimate error: the believed matrix policies plan against.
        #    None (no estimate machinery) aliases the true matrix — the
        #    perfectly-fresh default.
        self._estimates_on = (scenario.estimate_noise > 0
                              or scenario.estimate_refresh_period > 0)
        self.believed: Optional[np.ndarray] = None
        if self._estimates_on:
            self.believed = self.cluster.caps.copy()
            self.shares.believed = self.believed

        self.events = EventQueue()
        for t, node in sorted(scenario.failures):
            self.events.push(Event(t, FAILURE, (node,)))
        if scenario.shock_period > 0:
            self.events.push(Event(scenario.shock_period, CAPACITY_SHOCK))
        if scenario.read_rate > 0:
            self.events.push(Event(
                float(self.rng["read"].exponential(1.0 / scenario.read_rate)),
                READ_ARRIVAL))
        for t, node, factor, dur in sorted(scenario.degradations):
            self.events.push(Event(t, DEGRADE, (node, factor, dur)))
        if self._estimates_on:
            self._refresh_estimates()    # t=0 snapshot
            if scenario.estimate_refresh_period > 0:
                self.events.push(Event(scenario.estimate_refresh_period,
                                       ESTIMATE_REFRESH))
        if scenario.watchdog_period > 0:
            self.events.push(Event(scenario.watchdog_period, WATCHDOG))
        self.next_fail = self._draw_next_fail()
        self.next_degrade = self._draw_next_degrade()

        self.metrics = FleetMetrics(n=n, k=params.k,
                                    failure_rate=scenario.failure_rate)

        # -- coded data plane: allocated only when asked for;
        #    every touchpoint below is behind a ``dataplane is None`` guard
        #    and the "data" rng stream is drawn only here, so the default
        #    path keeps the exact pre-dataplane instruction stream
        self.dataplane = None
        self._trace_iter = None
        if scenario.dataplane:
            from .dataplane import DataPlane
            self.dataplane = DataPlane(scenario, params, self.shares,
                                       self.metrics, seed,
                                       recorder=self.recorder,
                                       device=self.device)
            self.metrics.dataplane = True
            if scenario.read_trace is not None:
                self._trace_iter = scenario.read_trace.arrivals(
                    self.rng["data"], scenario.duration)
                self._push_next_trace_read()

    # -- flight recorder helpers --------------------------------------------

    def _new_rid(self) -> int:
        """Next repair id.  Counted unconditionally (it is one integer
        increment and touches no rng), so traced and untraced runs agree
        on every id."""
        rid = self._rid_seq
        self._rid_seq += 1
        return rid

    def _emit_complete(self, r: ActiveRepair) -> None:
        """Called with ``r``'s links still acquired: the bottleneck is
        judged under the shares the repair actually finished at."""
        worst, worst_t = None, -1.0
        for link, f in r.links:
            s = self.shares.share(link)
            t = f / s if s > 0.0 else math.inf
            if worst is None or t > worst_t:
                worst, worst_t = link, t
        realized = self.now - r.plan_t0
        err = (realized / r.predicted - 1.0
               if math.isfinite(r.predicted) and r.predicted > 0 else None)
        self.recorder.emit(self.now, "repair_complete", rid=r.rid,
                           node=r.node, realized=realized,
                           predicted=r.predicted, plan_err=err,
                           regen=self.now - r.start_time,
                           wait=r.start_time - r.fail_time,
                           bottleneck=list(worst) if worst else None)
        self.recorder.emit(self.now, "node_repaired", node=r.node)

    # -- stochastic clocks --------------------------------------------------

    def _draw_next_fail(self) -> float:
        rate = self.scenario.failure_rate * self.cluster.num_healthy
        if rate <= 0:
            return math.inf
        return self.now + float(self.rng["fail"].exponential(1.0 / rate))

    def _draw_next_degrade(self) -> float:
        """Aggregate brownout clock.  Every slot's NIC is eligible
        regardless of health state (a brownout is a link-level fault, not
        a storage fault), so the rate is constant and the clock never
        needs redrawing on failures — the degrade stream stays independent
        of every other stream."""
        rate = self.scenario.degrade_rate * self.scenario.num_nodes
        if rate <= 0:
            return math.inf
        return self.now + float(self.rng["degrade"].exponential(1.0 / rate))

    # -- straggler/stall injection ------------------------------------------

    def _apply_degrade(self, node: int, factor: float,
                       duration: float) -> None:
        """Multiply ``node``'s outgoing link rates by ``factor`` for
        ``duration`` seconds.  Silent: no abort, no replan offer — only
        actual flow rates change (the run loop recomputes nominals every
        iteration).  A re-degrade supersedes the pending recovery via the
        generation counter."""
        assert self.degrade is not None
        self.degrade[node] = factor
        self.shares.invalidate_source(node)
        self._degrade_gen[node] += 1
        self.events.push(Event(self.now + duration, RECOVER,
                               (node, self._degrade_gen[node])))
        self.metrics.on_degrade()
        if self.recorder is not None:
            self.recorder.emit(self.now, "node_degrade", node=node,
                               factor=factor, duration=duration)

    def _poisson_degrade(self) -> None:
        sc = self.scenario
        rngd = self.rng["degrade"]
        victim = int(rngd.integers(sc.num_nodes))
        factor = float(rngd.uniform(sc.degrade_lo, sc.degrade_hi))
        duration = float(rngd.exponential(sc.degrade_mean_duration))
        self._apply_degrade(victim, factor, duration)
        self.next_degrade = self._draw_next_degrade()

    def _recover(self, node: int, gen: int) -> None:
        if self.degrade is not None and self._degrade_gen[node] == gen:
            self.degrade[node] = 1.0
            self.shares.invalidate_source(node)
            if self.recorder is not None:
                self.recorder.emit(self.now, "node_recover", node=node)

    # -- estimate error -----------------------------------------------------

    def _refresh_estimates(self) -> None:
        """Re-snapshot the believed matrix from the true effective
        capacities (shocks *and* brownouts included — monitoring measures
        achieved rates), multiplied by per-link U[1-e, 1+e] noise.
        Between refreshes the belief goes stale: shocks and brownouts that
        happen after the snapshot are invisible to the planner."""
        assert self.believed is not None
        eff = self.cluster.caps
        if self.degrade is not None:
            eff = eff * self.degrade[:, None]
        noise = self.scenario.estimate_noise
        if noise > 0:
            mult = self.rng["est"].uniform(1.0 - noise, 1.0 + noise,
                                           size=eff.shape)
            self.believed[:] = eff * mult
        else:
            self.believed[:] = eff
        np.fill_diagonal(self.believed, 0.0)
        if self.recorder is not None:
            self.recorder.emit(self.now, "estimate_refresh")

    # -- event handlers -----------------------------------------------------

    def _apply_failure(self, node: int) -> bool:
        """Fail ``node``; returns whether the healthy population actually
        changed (False for a redundant injection on an already-down slot,
        in which case the caller must NOT redraw the Poisson clock — a
        no-op redraw would shift the rng stream and break seeded
        comparability between scenarios that differ only in a redundant
        injection)."""
        if self.cluster.state[node] != 0:       # already failed / repairing
            return False
        self.cluster.fail(node)
        if self.recorder is not None:
            self.recorder.emit(self.now, "node_fail", node=node)
        if self.cluster.num_healthy < self.params.k:
            self.metrics.on_data_loss()
            if self.recorder is not None:
                self.recorder.emit(self.now, "data_loss",
                                   unavailable=self.cluster.num_unavailable)
        self.queue.append(QueuedRepair(self.now, node, rid=self._new_rid()))
        if self.recorder is not None:
            self.recorder.emit(self.now, "repair_queued",
                               rid=self.queue[-1].rid, node=node,
                               reason="fail")
        # tear down degraded reads touching the failed node: their links
        # must not linger as phantom flows until the scheduled departure
        # (the stale READ_DEPARTURE becomes a no-op when it fires).  The
        # node -> rids index replaces the all-reads scan; sorting restores
        # the arrival (dict insertion) order the scan released in.  Reads
        # injected directly into ``self.reads`` (tests craft these) bypass
        # the index, so fall back to the scan unless it covers every read
        if len(self._indexed_rids) == len(self.reads):
            dead_reads = sorted(self._reads_at.get(node, ()))
        else:
            dead_reads = [rid for rid, links in self.reads.items()
                          if any(node in link for link, _ in links)]
        for rid in dead_reads:
            links = self.reads.pop(rid)
            self.shares.release(links)
            self._unindex_read(rid, links)
        # data-plane reads touching the node die too (partial fragment
        # bytes already on the wire stay in the read ledger)
        if self.dataplane is not None:
            self.dataplane.teardown_node(node, self.now)
        # abort in-flight repairs that lost a provider.  node is healthy
        # until this failure while every r.ids[0] slot is REPAIRING, so
        # membership in ids is membership in the providers tail
        lost = [i for i, r in enumerate(self.active) if node in r.ids]
        for i in reversed(lost):
            r = self.active.pop(i)
            if self.dataplane is not None:
                # the delivered fraction of this segment crossed the wire;
                # ledger it before release/rebase destroy the progress state
                self.dataplane.account_repair_wire(r, 1.0 - r.remaining)
            self.shares.release(r.links, r)
            self.cluster.abort_repair(r.node)
            if self.scenario.carryover:
                # keep blocks already received — except those parked at the
                # failed provider itself, which died with its host.  Blocks
                # it *sent* have already landed downstream and survive.
                bank = {link: b for link, b in r.banked_now().items()
                        if link[1] != node}
                survivors = tuple(p for p in r.providers if p != node)
                self.queue.append(QueuedRepair(r.fail_time, r.node,
                                               bank, survivors, rid=r.rid))
                self.metrics.on_abort(carryover=True)
            else:
                self.queue.append(QueuedRepair(r.fail_time, r.node,
                                               rid=r.rid))
                self.metrics.on_abort(carryover=False)
            if self.recorder is not None:
                self.recorder.emit(self.now, "repair_abort", rid=r.rid,
                                   node=r.node, lost_provider=node,
                                   carryover=self.scenario.carryover)
                self.recorder.emit(self.now, "repair_queued", rid=r.rid,
                                   node=r.node, reason="abort")
        if lost:
            # requeued aborts carry older fail_times than the failure that
            # evicted them; restore oldest-first admission order (stable on
            # ties, so same-time entries keep insertion order)
            self.queue.sort(key=lambda q: q.fail_time)
            self._replan_pending = True
        # banked blocks sitting *at* the failed node are gone for queued
        # repairs too (the host is replaced before it can relay them on)
        for i, q in enumerate(self.queue):
            if q.bank and any(link[1] == node for link in q.bank):
                self.queue[i] = q._replace(
                    bank={l: b for l, b in q.bank.items() if l[1] != node})
        return True

    def _poisson_failure(self) -> None:
        healthy = self.cluster.healthy_nodes()
        if healthy:
            # integers(0, n) consumes the identical stream draw as the
            # uniform scalar choice(n) it replaces, minus its array setup
            victim = int(self.rng["fail"].integers(0, len(healthy)))
            victims = [healthy[victim]]
            sc = self.scenario
            if (sc.rack_size > 0 and sc.rack_burst_prob > 0
                    and self.rng["fail"].random() < sc.rack_burst_prob):
                peers = [p for p in self.cluster.rack_peers(victims[0])
                         if self.cluster.state[p] == 0]
                extra = min(sc.rack_burst_extra, len(peers))
                if extra:
                    idx = self.rng["fail"].choice(len(peers), size=extra,
                                                  replace=False)
                    victims += [peers[int(i)] for i in idx]
            for v in victims:
                self._apply_failure(v)
        self.next_fail = self._draw_next_fail()

    def _capacity_shock(self) -> None:
        sc = self.scenario
        n = sc.num_nodes
        mult = self.rng["shock"].uniform(sc.shock_lo, sc.shock_hi,
                                         size=(n, n))
        self.cluster.caps[:] = self.caps_base * mult
        np.fill_diagonal(self.cluster.caps, 0.0)
        self.events.push(Event(self.now + sc.shock_period, CAPACITY_SHOCK))
        self._replan_pending = True
        if self.recorder is not None:
            self.recorder.emit(self.now, "capacity_shock")

    def _read_arrival(self) -> None:
        """Closed-loop degraded read (legacy ``read_rate`` path): only fires
        while a slot is down.  With the data plane on, the identical rng
        draws pick the endpoints, then the read becomes a fragment-transfer
        flow (completion from contention; ``read_duration`` ignored)
        instead of a fixed-duration phantom."""
        sc = self.scenario
        healthy = self.cluster.healthy_nodes()
        fanin = sc.read_fanin or self.params.k
        if self.cluster.num_unavailable > 0 and len(healthy) > fanin:
            dst_i = int(self.rng["read"].integers(0, len(healthy)))  # == choice(n)
            dst = healthy[dst_i]
            # index remap stands in for the dst-excluding pool listcomp:
            # pool[i] == healthy[i] for i < dst_i else healthy[i + 1],
            # so the rng draw below sees the identical pool size
            idx = self.rng["read"].choice(len(healthy) - 1, size=fanin,
                                          replace=False)
            picked = [healthy[j if j < dst_i else j + 1]
                      for j in (int(i) for i in idx)]
            if self.dataplane is not None:
                self.dataplane.start_read(self.now, dst, picked)
            else:
                links = [((src, dst), 1.0) for src in picked]
                self.shares.acquire(links)
                rid = self._read_seq
                self._read_seq += 1
                self.reads[rid] = links
                self._index_read(rid, links)
                self.events.push(Event(self.now + sc.read_duration,
                                       READ_DEPARTURE, (rid,)))
        self.events.push(Event(
            self.now + float(self.rng["read"].exponential(1.0 / sc.read_rate)),
            READ_ARRIVAL))

    def _push_next_trace_read(self) -> None:
        """Pull the next open-loop arrival lazily (one at a time, so file
        traces of millions of reads never materialize in memory)."""
        t = next(self._trace_iter, None)
        if t is not None:
            self.events.push(Event(float(t), TRACE_READ))

    def _trace_read_arrival(self) -> None:
        """Open-loop trace read: served
        whenever >= fanin + 1 healthy nodes exist — degraded or not, an
        open-loop user read always fetches its fragments — and *dropped*
        (counted, recorded) otherwise.  Contrast ``_read_arrival``, whose
        closed-loop reads model degraded-slot reconstruction and only fire
        while a slot is down.  Endpoint draws come from the dedicated
        "data" stream, so trace mode never shifts the legacy read stream."""
        dp = self.dataplane
        healthy = self.cluster.healthy_nodes()
        if len(healthy) > dp.fanin:
            rngd = self.rng["data"]
            dst_i = int(rngd.integers(0, len(healthy)))
            dst = healthy[dst_i]
            idx = rngd.choice(len(healthy) - 1, size=dp.fanin, replace=False)
            picked = [healthy[j if j < dst_i else j + 1]
                      for j in (int(i) for i in idx)]
            dp.start_read(self.now, dst, picked)
        else:
            self.metrics.on_read_drop()
            if self.recorder is not None:
                self.recorder.emit(self.now, "read_drop",
                                   healthy=len(healthy), fanin=dp.fanin)
        self._push_next_trace_read()

    def _read_departure(self, rid: int) -> None:
        links = self.reads.pop(rid, None)
        if links is not None:
            self.shares.release(links)
            self._unindex_read(rid, links)

    def _index_read(self, rid: int, links) -> None:
        at = self._reads_at
        for (src, dst), _ in links:
            at.setdefault(src, set()).add(rid)
            at.setdefault(dst, set()).add(rid)
        self._indexed_rids.add(rid)

    def _unindex_read(self, rid: int, links) -> None:
        at = self._reads_at
        for (src, dst), _ in links:
            s = at.get(src)
            if s is not None:
                s.discard(rid)
            s = at.get(dst)
            if s is not None:
                s.discard(rid)
        self._indexed_rids.discard(rid)

    # -- repair admission ---------------------------------------------------

    def _pick_providers(self, failed: int, healthy: List[int],
                        survivors: Sequence[int] = (),
                        d: Optional[int] = None,
                        avoid: Sequence[int] = ()) -> List[int]:
        """Choose ``d`` providers (default ``params.d``).  ``survivors``
        (still-healthy providers of a carryover-aborted plan) are kept so
        the banked links can be re-credited, and only the deficit is drawn
        fresh; with no survivors the draw is identical to the
        pre-carryover uniform sample.  ``avoid`` names watchdog-evicted
        stragglers: they are excluded from the fresh draw while enough
        alternatives exist (best effort — with a thin pool they come back
        into play rather than starving the repair)."""
        if d is None:
            d = self.params.d
        if self.scenario.provider_picker is not None:
            return list(self.scenario.provider_picker(failed, healthy,
                                                      self.rng["prov"]))
        alive = self.cluster.healthy_set()
        keep = [s for s in survivors if s in alive][:d]
        deficit = d - len(keep)
        if not deficit:
            return keep
        # no survivors (the common case): healthy itself is the pool
        # (read-only cached list, never mutated here)
        pool = healthy if not keep else [h for h in healthy if h not in keep]
        if avoid:
            trimmed = [h for h in pool if h not in avoid]
            if len(trimmed) >= deficit:
                pool = trimmed
        idx = self.rng["prov"].choice(len(pool), size=deficit,
                                      replace=False)
        return keep + [pool[int(i)] for i in idx]

    def _drain_queue(self) -> None:
        """Start every currently-startable repair, planned as one batch.

        A repair whose plan comes back with infinite time (it was routed
        over a zero-capacity link) must not start: it would hold its links
        and a ``max_concurrent`` slot forever under static capacities.  It
        is excluded from this epoch's batch and requeued — a later epoch
        (new providers, restored capacity) gets to retry it.  Deferral
        frees the admission slots it held, so the collection loop runs
        again for the rest of the queue; with no dead overlays (the normal
        case) exactly one batched planning call is made per epoch.
        """
        if not self.queue:
            return              # nothing admissible: skip the batch setup
        deferred: List[QueuedRepair] = []
        sc = self.scenario
        while True:
            startable: List[Tuple[QueuedRepair, List[int], CodeParams]] = []
            while (self.queue
                   and len(self.active) + len(startable)
                   < sc.max_concurrent):
                healthy = self.cluster.healthy_nodes()
                d_eff = self.params.d
                if len(healthy) < d_eff:
                    if sc.degraded_d and len(healthy) >= self.params.k:
                        # graceful degradation: functional repair with
                        # d' = |healthy| in [k, d) helpers instead of
                        # queueing until the population recovers
                        d_eff = len(healthy)
                    else:
                        break
                q = self.queue.pop(0)
                self.cluster.start_repair(q.node)
                try:
                    ids = [q.node] + self._pick_providers(
                        q.node, healthy, q.survivors, d_eff, q.avoid)
                    if len(set(ids)) != d_eff + 1:
                        raise ValueError(
                            f"provider picker returned {ids[1:]} for slot "
                            f"{q.node}: need {d_eff} distinct providers "
                            f"!= the slot")
                except Exception:
                    # roll back every slot this batch already flipped to
                    # REPAIRING (no ActiveRepair exists for them yet) and
                    # restore the queue, so a picker error leaves the
                    # cluster consistent instead of slots wedged in
                    # REPAIRING with no repair that could ever finish
                    self.cluster.abort_repair(q.node)
                    for qq, _, _ in startable:
                        self.cluster.abort_repair(qq.node)
                    self.queue = ([qq for qq, _, _ in startable] + [q]
                                  + self.queue + deferred)
                    raise
                params_eff = (self.params if d_eff == self.params.d else
                              dataclasses.replace(self.params, d=d_eff))
                startable.append((q, ids, params_eff))
            if not startable:
                break
            # one batched planning call per distinct repair fan-out — one
            # call total on the default path (degraded-d admissions only
            # happen when the cluster is nearly dead)
            by_d: Dict[int, List[int]] = {}
            for i, (_, ids, _) in enumerate(startable):
                by_d.setdefault(len(ids) - 1, []).append(i)
            plans: list = [None] * len(startable)
            for d_eff in sorted(by_d):
                rows = by_d[d_eff]
                overlays = self.shares.residual_overlays(
                    [startable[i][1] for i in rows])
                got = self.policy.plan_batch(overlays, startable[rows[0]][2],
                                             device=self.device)
                for i, plan in zip(rows, got):
                    plans[i] = plan
            num_deferred = 0
            for (q, ids, params_eff), plan in zip(startable, plans):
                if not math.isfinite(plan.time):
                    self.cluster.abort_repair(q.node)   # back to FAILED
                    deferred.append(q)
                    num_deferred += 1
                    if self.recorder is not None:
                        self.recorder.emit(self.now, "repair_deferred",
                                           rid=q.rid, node=q.node)
                    continue
                flows = plan_links(plan, ids)
                if q.bank:
                    links, credited, total = apply_credit(flows, q.bank)
                    self.metrics.on_carryover(credited, total)
                    bank = dict(q.bank)
                else:
                    links, bank = flows, {}
                # the ETA this plan promises under the believed capacities
                # at its own admission instant — the realized duration is
                # measured against it (plan-error distribution)
                predicted = self.shares.admission_time(links)
                r = ActiveRepair(
                    node=q.node, plan=plan, ids=list(ids), links=links,
                    fail_time=q.fail_time, start_time=self.now, bank=bank,
                    plan_t0=self.now, predicted=predicted,
                    retries=q.retries, next_check=q.next_check,
                    avoid=q.avoid, rid=q.rid)
                self.shares.acquire(links, r)
                if len(ids) - 1 < self.params.d:
                    self.metrics.on_degraded_admission()
                self.active.append(r)
                if self.recorder is not None:
                    self.recorder.emit(
                        self.now, "repair_admitted", rid=q.rid, node=q.node,
                        scheme=plan.scheme, d=len(ids) - 1,
                        helpers=[int(h) for h in ids[1:]],
                        banked=float(sum(bank.values())) if bank else 0.0,
                        predicted=predicted,
                        degraded=len(ids) - 1 < self.params.d)
            if not num_deferred:
                break
        if deferred:
            self.queue.extend(deferred)
            self.queue.sort(key=lambda q: q.fail_time)

    # -- in-flight plan migration -------------------------------------------

    def _maybe_replan(self) -> None:
        """Offer every in-flight repair a migration (one batched
        ``policy.replan`` call), accepting a proposal only if its
        banked-credited ETA beats the current one.

        Caller guarantees nominals are fresh (``shares.recompute``).  Each
        proposal is evaluated under self-excluded shares — the repair's own
        occupancy is discounted, so staying on a link costs what it costs
        today and leaving one frees it.  Like admission, proposals are a
        same-epoch snapshot: an accepted migration changes the shares its
        successors are judged under (we recompute between accepts), but the
        overlays the policy planned against are not re-stacked.

        With ``Scenario.bank_aware_migration`` on the policy
        returns *every* candidate plan per repair
        (``replan_candidates``) and the simulator picks the one
        minimizing the banked-credited ETA, so a tree overlapping
        already-received blocks can beat the nominally-fastest tree.  Off
        (default) the single ``replan`` proposal goes through the same
        scoring, which degenerates to the nominal-time accept test bitwise.
        """
        bank_aware = self.scenario.bank_aware_migration
        groups: Dict[int, List[ActiveRepair]] = {}
        for r in self.active:
            groups.setdefault(len(r.ids) - 1, []).append(r)
        for d_eff in sorted(groups):
            params_eff = (self.params if d_eff == self.params.d else
                          dataclasses.replace(self.params, d=d_eff))
            group = groups[d_eff]
            overlays = self.shares.residual_overlays(
                [r.ids for r in group],
                excludes=[frozenset(l for l, _ in r.links) for r in group])
            if bank_aware:
                cand_lists = self.policy.replan_candidates(
                    overlays, params_eff, device=self.device)
            else:
                cand_lists = [[p] for p in
                              self.policy.replan(overlays, params_eff,
                                                 device=self.device)]
            for r, plans in zip(group, cand_lists):
                best = self._best_candidate(r, plans)
                if best is None:
                    continue
                plan, links, bank, credited, total, eta_new = best
                if eta_new >= r.eta():
                    continue
                if self.dataplane is not None:
                    self.dataplane.account_repair_wire(r, 1.0 - r.remaining)
                self.shares.release(r.links, r)
                r.rebase(plan, links, bank)
                self.shares.acquire(r.links, r)
                r.plan_t0 = self.now
                r.predicted = eta_new
                self.metrics.on_migration(credited, total)
                if self.recorder is not None:
                    self.recorder.emit(self.now, "repair_replan", rid=r.rid,
                                       node=r.node, kind="migration",
                                       scheme=plan.scheme, credited=credited,
                                       total=total, predicted=eta_new)
                self.shares.recompute(self._contending())

    def _best_candidate(self, r: ActiveRepair, plans: Sequence,
                        ) -> Optional[tuple]:
        """Score replacement-plan candidates for in-flight repair ``r`` by
        *credited* ETA under self-excluded shares — banked blocks are
        subtracted from each candidate's demands first, so overlap with
        already-received work counts for exactly what it saves.  Returns
        the winning ``(plan, links, bank, credited, total, eta)`` or
        ``None``; the first minimum wins ties (candidate order is the
        policy's scheme preference), keeping the choice deterministic."""
        occupied = frozenset(l for l, _ in r.links)
        bank = r.banked_now()
        best = None
        for plan in plans:
            if plan is None or not math.isfinite(plan.time):
                continue
            links, credited, total = apply_credit(
                plan_links(plan, r.ids), bank)
            eta = self.shares.admission_time(links, exclude=occupied)
            if best is None or eta < best[5]:
                best = (plan, links, bank, credited, total, eta)
        return best

    # -- watchdog: plan-vs-reality mitigation -------------------------------

    def _watchdog(self) -> None:
        """Flag every in-flight repair whose realized progress trails its
        plan-predicted trajectory by more than ``watchdog_lag``x — or whose
        ETA is outright infinite (a stall; the ratio test alone would never
        flag a 90%-done repair whose last link browned out to zero) — and
        escalate mitigation.  Repairs inside their backoff window
        (``next_check``) are skipped, including given-up ones
        (``next_check == inf``)."""
        sc = self.scenario
        for r in list(self.active):
            if self.now < r.next_check:
                continue
            elapsed = self.now - r.plan_t0
            if elapsed <= 0.0:
                continue
            stalled = not math.isfinite(r.eta())
            done = 1.0 - r.remaining
            expected = (min(1.0, elapsed / r.predicted)
                        if math.isfinite(r.predicted) and r.predicted > 0
                        else 0.0)
            if stalled or done * sc.watchdog_lag < expected:
                self.metrics.on_watchdog_flag()
                if self.recorder is not None:
                    self.recorder.emit(self.now, "watchdog_flag", rid=r.rid,
                                       node=r.node, stalled=stalled,
                                       done=done, expected=expected)
                self._mitigate(r)
        self.events.push(Event(self.now + sc.watchdog_period, WATCHDOG))

    def _mitigate(self, r: ActiveRepair) -> None:
        """Escalating mitigation ladder for a flagged repair.

        Attempt 0 is a credited in-place replan over the current believed
        capacities; attempts 1..``watchdog_retries`` evict the straggling
        provider and retry with a fresh helper (so the budget buys one
        rescue replan plus ``watchdog_retries`` evictions).  Each attempt
        pushes the next check out by ``watchdog_period * backoff^attempt``;
        past the budget the repair is left to limp along at whatever rate
        it gets, and further flags are suppressed (``next_check = inf``).
        The attempt counter lives on the repair and survives eviction
        requeues, so a chronically lagging slot cannot reset its own
        budget by being mitigated."""
        sc = self.scenario
        attempt = r.retries
        if attempt > sc.watchdog_retries:
            self.metrics.on_watchdog_giveup()
            if self.recorder is not None:
                self.recorder.emit(self.now, "watchdog_giveup", rid=r.rid,
                                   node=r.node, retries=attempt)
            r.next_check = math.inf
            return
        r.retries = attempt + 1
        r.next_check = (self.now
                        + sc.watchdog_period * sc.watchdog_backoff ** attempt)
        if attempt == 0:
            self._watchdog_replan(r)
        else:
            self._evict_straggler(r)

    def _watchdog_replan(self, r: ActiveRepair) -> None:
        """Rescue attempt 0: a single-row ``policy.replan`` over the
        repair's self-excluded believed overlay, accepted only if the
        banked-credited ETA beats the current one.  Unlike opportunistic
        migration this runs even with ``Scenario.migration`` off — it is a
        targeted rescue.  Note both ETAs are believed-view predictions: a
        replan can be accepted and still be stalled in reality (the
        believed map does not know about the brownout), in which case the
        next flag escalates to eviction."""
        d_eff = len(r.ids) - 1
        params_eff = (self.params if d_eff == self.params.d else
                      dataclasses.replace(self.params, d=d_eff))
        occupied = frozenset(l for l, _ in r.links)
        overlay = self.shares.residual_overlay(r.ids, exclude=occupied)
        if self.scenario.bank_aware_migration:
            cands = self.policy.replan_candidates(overlay[None, ...],
                                                  params_eff,
                                                  device=self.device)
            plans = cands[0] if cands else []
        else:
            proposals = self.policy.replan(overlay[None, ...], params_eff,
                                           device=self.device)
            plans = [proposals[0]] if proposals else []
        best = self._best_candidate(r, plans)
        if best is None:
            return
        plan, links, bank, credited, total, eta_new = best
        if eta_new >= r.eta():
            return
        if self.dataplane is not None:
            self.dataplane.account_repair_wire(r, 1.0 - r.remaining)
        self.shares.release(r.links, r)
        r.rebase(plan, links, bank)
        self.shares.acquire(r.links, r)
        r.plan_t0 = self.now
        r.predicted = eta_new
        self.metrics.on_watchdog_replan(credited, total)
        if self.recorder is not None:
            self.recorder.emit(self.now, "repair_replan", rid=r.rid,
                               node=r.node, kind="watchdog",
                               scheme=plan.scheme, credited=credited,
                               total=total, predicted=eta_new)
        self.shares.recompute(self._contending())

    def _evict_straggler(self, r: ActiveRepair) -> None:
        """Evict the provider feeding the repair's bottleneck link —
        judged under *true* shares, because the watchdog observes achieved
        rates, not the believed map — and requeue the slot with its banked
        blocks, surviving providers, and an ``avoid`` entry so re-admission
        draws a fresh helper.  Mirrors the provider-loss carryover abort:
        blocks parked *at* the evicted provider leave the plan with it
        (it is no longer part of the tree to relay them), blocks it already
        sent have landed downstream and stay banked."""
        worst_link, worst_t = None, -1.0
        for link, f in r.links:
            if link[0] == r.node:
                continue                    # never evict the newcomer
            s = self.shares.share(link)
            t = f / s if s > 0.0 else math.inf
            if worst_link is None or t > worst_t:
                worst_link, worst_t = link, t
        if worst_link is None:              # no evictable residual links
            return
        straggler = worst_link[0]
        if self.dataplane is not None:
            self.dataplane.account_repair_wire(r, 1.0 - r.remaining)
        self.shares.release(r.links, r)
        self.active.remove(r)
        self.cluster.abort_repair(r.node)
        bank = {link: b for link, b in r.banked_now().items()
                if link[1] != straggler}
        survivors = tuple(p for p in r.providers if p != straggler)
        self.queue.append(QueuedRepair(
            r.fail_time, r.node, bank, survivors,
            avoid=r.avoid + (straggler,), retries=r.retries,
            next_check=r.next_check, rid=r.rid))
        self.queue.sort(key=lambda q: q.fail_time)
        self.metrics.on_eviction()
        if self.recorder is not None:
            self.recorder.emit(self.now, "repair_evicted", rid=r.rid,
                               node=r.node, straggler=straggler,
                               banked=float(sum(bank.values())))
            self.recorder.emit(self.now, "repair_queued", rid=r.rid,
                               node=r.node, reason="evict")

    # -- main loop ----------------------------------------------------------

    def _contending(self) -> List[ActiveRepair]:
        """Every flow the share engine must keep fresh: active repairs
        plus in-flight data-plane reads (one population — the incremental
        engine refreshes exactly the items passed here, and its
        registration-count fast path compares against this list's
        length).  With the data plane off this IS ``self.active``, so the
        default path passes the identical object it always did."""
        dp = self.dataplane
        if dp is None or not dp.reads:
            return self.active
        return self.active + dp.reads

    def _next_completion(self) -> Tuple[float, int]:
        """(absolute time, index into self.active) of the earliest finishing
        repair; on ties the strict < keeps the first hit, and ``active`` is
        in start order, so the earliest-started repair wins.  ``eta`` is
        inlined — this scan runs every event epoch."""
        best_t, best_i = math.inf, -1
        now = self.now
        for i, r in enumerate(self.active):
            rem = r.remaining
            t = now + rem * r.nominal if rem > 0.0 else now
            if t < best_t:
                best_t, best_i = t, i
        return best_t, best_i

    def _advance(self, t: float) -> None:
        dt = t - self.now
        # inlined ActiveRepair.advance (same arithmetic, pinned by the
        # goldens): only a finite positive nominal accrues progress, and a
        # zero nominal (degenerate all-tiny-flow plan) finishes outright
        if dt < 0:
            raise ValueError(f"negative time step {dt}")
        if dt == 0.0:
            # same-epoch advance: rem - 0.0/nom == rem bitwise, so only the
            # degenerate zero-nominal finish-outright branch has any effect
            for r in self.active:
                if r.nominal == 0.0:
                    r.remaining = 0.0
        else:
            for r in self.active:
                nom = r.nominal
                if nom > 0.0 and nom != math.inf:
                    rem = r.remaining - dt / nom
                    r.remaining = rem if rem > 0.0 else 0.0
                elif nom == 0.0:
                    r.remaining = 0.0
        if self.dataplane is not None:
            self.dataplane.advance_reads(dt)
        self.now = t
        self.metrics.observe(t, len(self.queue) + len(self.active),
                             self.cluster.num_unavailable)

    def _complete(self, i: int) -> None:
        r = self.active.pop(i)
        if self.recorder is not None:
            self._emit_complete(r)          # before releasing the links
        if self.dataplane is not None:
            # the final segment delivered in full; ledger its wire bytes,
            # then replay the plan on the coded store (provider encode /
            # interior relay / newcomer regenerate) and optionally
            # decode-verify the regenerated node
            self.dataplane.account_repair_wire(r, 1.0)
            self.dataplane.on_repair_complete(r, self.now)
        r.remaining = 0.0
        self.shares.release(r.links, r)
        self.cluster.complete_repair(r.node)
        self.metrics.on_complete(r.fail_time, r.start_time, self.now,
                                 r.plan_t0, r.predicted)
        # the healthy population grew: re-draw the aggregate failure clock
        # (memorylessness makes the re-draw exact, same as on failures)
        self.next_fail = self._draw_next_fail()

    def _complete_read(self, ri: int) -> None:
        self.dataplane.complete_read(ri, self.now)

    def _refresh_pending(self) -> None:
        """Cache (next event time, completion time, completion index, heap
        time) for the next :meth:`step`.  Nothing can change simulator
        state between the end of one step and the start of the next, so
        computing this once per step (instead of at the top of each loop
        iteration) is exact — and it is what exposes
        :meth:`next_event_time` to the lockstep ensemble loop without
        re-scanning the active set."""
        t_comp, ci = self._next_completion()
        if self.dataplane is not None:
            t_read, ri = self.dataplane.next_read_completion(self.now)
        else:
            t_read, ri = math.inf, -1
        t_exo = self.events.peek_time()
        t_next = min(t_comp, t_read, t_exo, self.next_fail,
                     self.next_degrade)
        self._pending = (t_next, t_comp, ci, t_exo, t_read, ri)

    def next_event_time(self) -> float:
        """Absolute time of the next event epoch (``inf`` when idle) —
        valid after :meth:`start` and between :meth:`step` calls.  The
        ensemble loop keys its lockstep heap on this."""
        return self._pending[0]

    def start(self) -> None:
        """Prime the loop: t=0 observation, initial admissions, shares.
        Idempotent guard so ``run()`` after a manual ``start()`` works."""
        if self._started:
            return
        self._started = True
        self.metrics.observe(0.0, len(self.queue) + len(self.active),
                             self.cluster.num_unavailable)
        self._drain_queue()
        self.shares.recompute(self._contending())
        self._refresh_pending()

    def step(self) -> bool:
        """Process one event epoch; returns False once the horizon is
        reached (the final advance to ``duration`` has then been made).
        ``run()`` is ``start(); while step(): pass`` — the split lets the
        ensemble loop interleave many simulators in lockstep."""
        end = self.scenario.duration
        t_next, t_comp, ci, t_exo, t_read, ri = self._pending
        if t_next > end or not math.isfinite(t_next):
            self._advance(end)
            return False
        self.loop_events += 1
        self._advance(t_next)
        # fixed same-time precedence: repair completion, read completion,
        # heap, Poisson failure clock, Poisson degrade clock (with the
        # data plane off t_read is inf, so the dispatch reduces to the
        # pre-dataplane chain bitwise)
        if (t_comp <= t_read and t_comp <= t_exo
                and t_comp <= self.next_fail
                and t_comp <= self.next_degrade):
            self._complete(ci)
        elif (t_read <= t_exo and t_read <= self.next_fail
                and t_read <= self.next_degrade):
            self._complete_read(ri)
        elif t_exo <= self.next_fail and t_exo <= self.next_degrade:
            ev = self.events.pop()
            if ev.kind == FAILURE:
                if self._apply_failure(ev.payload[0]):
                    # redraw only when the healthy population actually
                    # changed; a redundant injection must not shift the
                    # Poisson stream (memorylessness keeps the old draw
                    # exact when the rate is unchanged)
                    self.next_fail = self._draw_next_fail()
            elif ev.kind == CAPACITY_SHOCK:
                self._capacity_shock()
                # a shock epoch rewrites the capacity matrix in place —
                # overridden shocks (tests subclass the hook) included, so
                # the invalidation lives at the dispatch site, not inside
                # the default implementation
                self.shares.invalidate_all()
            elif ev.kind == READ_ARRIVAL:
                self._read_arrival()
            elif ev.kind == READ_DEPARTURE:
                self._read_departure(ev.payload[0])
            elif ev.kind == TRACE_READ:
                self._trace_read_arrival()
            elif ev.kind == DEGRADE:
                self._apply_degrade(*ev.payload)
            elif ev.kind == RECOVER:
                self._recover(*ev.payload)
            elif ev.kind == ESTIMATE_REFRESH:
                self._refresh_estimates()
                self.events.push(Event(
                    self.now + self.scenario.estimate_refresh_period,
                    ESTIMATE_REFRESH))
            elif ev.kind == WATCHDOG:
                self._watchdog()
        elif self.next_fail <= self.next_degrade:
            self._poisson_failure()
        else:
            self._poisson_degrade()
        if (self._estimates_on
                and self.scenario.estimate_refresh_period == 0):
            # period 0 = perfectly fresh (but still noisy) estimates:
            # re-snapshot every epoch so the noise alone is the error
            self._refresh_estimates()
        if self._replan_pending:
            self._replan_pending = False
            if self.scenario.migration and self.active:
                self.shares.recompute(self._contending())
                self._maybe_replan()
        self._drain_queue()
        self.shares.recompute(self._contending())
        self.metrics.observe(self.now,
                             len(self.queue) + len(self.active),
                             self.cluster.num_unavailable)
        self._refresh_pending()
        return True

    def finish(self) -> FleetMetrics:
        """Close the books after the last :meth:`step` and return the
        metrics — the third piece of the start/step/finish loop split
        the ensemble loop composes."""
        if self.recorder is not None:
            # close the books: exact link aggregates and the legacy summary
            # ride in the trace header, so one file is self-contained
            self.link_tracer.finish(self.now)
            self.recorder.meta["links"] = self.link_tracer.snapshot()
            if self.dataplane is not None:
                self.recorder.meta["dataplane"] = self.dataplane.snapshot()
            self.recorder.meta["summary"] = self.metrics.summary()
        return self.metrics

    def run(self) -> FleetMetrics:
        self.start()
        while self.step():
            pass
        return self.finish()


def simulate(scenario: Scenario, policy: RepairPolicy, params: CodeParams,
             seed: int = 0, device: DeviceLike = None) -> dict:
    """One-call entry point: run and return the metrics summary.
    ``device`` as for :class:`FleetSimulator`."""
    return FleetSimulator(scenario, policy, params, seed=seed,
                          device=device).run().summary()
