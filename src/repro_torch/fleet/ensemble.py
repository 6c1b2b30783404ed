"""Lockstep multi-cluster Monte-Carlo: region scale from cluster sims.

A region is not one giant cluster — it is many independent clusters run
under the same operational regime.  This module drives K
:class:`~repro_torch.fleet.sim.FleetSimulator` instances (one scenario, K
distinct seed streams) in *lockstep*: a single event-time heap pops
whichever cluster owns the globally next event and advances exactly that
one by one event.  Each cluster's trajectory is untouched by the
interleaving — cluster state is fully private, so every member produces
bit-for-bit the metrics its solo ``run()`` would — but the single-loop
structure is what a region-scale study needs: one wall clock, one place to
observe the whole fleet mid-flight, and the hook point for any future
cross-cluster coupling (shared WAN budget, global repair throttles).

Statistics come out two ways:

* :func:`pool_metrics` — one pooled :class:`FleetMetrics` whose
  ``summary()`` is the region-level estimate: time-integrals, counters
  and sim-time sum across clusters (so ``mean_backlog`` is the
  cluster-time-weighted mean |Σ∫b dt / Σdur| and ``mttdl_estimate`` is
  ``Σdur / ΣE[losses]``), per-repair samples concatenate (so pooled
  percentiles weight clusters by how many repairs they actually ran).
* :func:`bootstrap_cis` — cluster-level bootstrap: resample the K
  member metrics with replacement, re-pool, re-summarize.  Clusters are
  the i.i.d. unit here (repairs within one cluster are autocorrelated
  through its queue), so resampling clusters is the defensible CI, and
  it needs no distributional assumption on heavy-tailed keys like
  ``regen_p99``.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import CodeParams
from ..device import DeviceLike, resolve_device

from .metrics import COUNTER_SUMMARY_KEYS, FleetMetrics
from .policy import RepairPolicy
from .scenario import Scenario
from .sim import FleetSimulator

__all__ = ["ClusterEnsemble", "bootstrap_cis", "cluster_seed",
           "pool_metrics"]


def cluster_seed(root_seed: int, k: int) -> int:
    """Derived seed for ensemble member ``k`` — distinct, deterministic,
    and stable under changing K (member 3 keeps its trajectory whether
    the ensemble has 4 or 400 clusters)."""
    return (root_seed * 1_000_003 + k) % (1 << 31)


def pool_metrics(members: Sequence[FleetMetrics]) -> FleetMetrics:
    """Pool member metrics into one region-level :class:`FleetMetrics`.

    Time integrals (``backlog_integral``, ``unavail_time``,
    ``at_risk_time``, ``expected_losses``) and ``now`` sum, so every
    ratio ``summary()`` forms over duration is automatically the
    cluster-time-weighted pooled estimate.  Counters sum via the
    :data:`COUNTER_SUMMARY_KEYS` registry (anything added there pools
    with no change here), except ``max_backlog`` which pools as a max —
    it is a high-water mark, not a flow.  Sample lists concatenate.
    The pooled object is an accumulator snapshot: call ``summary()`` on
    it, don't ``observe()`` into it.
    """
    if not members:
        raise ValueError("cannot pool an empty ensemble")
    base = members[0]
    pooled = FleetMetrics(n=base.n, k=base.k, failure_rate=base.failure_rate)
    for m in members:
        pooled.now += m.now
        pooled.backlog_integral += m.backlog_integral
        pooled.unavail_time += m.unavail_time
        pooled.at_risk_time += m.at_risk_time
        pooled.expected_losses += m.expected_losses
        for attr in COUNTER_SUMMARY_KEYS:
            if attr == "max_backlog":
                pooled.max_backlog = max(pooled.max_backlog, m.max_backlog)
            else:
                setattr(pooled, attr,
                        getattr(pooled, attr) + getattr(m, attr))
        pooled.plan_errors.extend(m.plan_errors)
        pooled.credit_fractions.extend(m.credit_fractions)
        pooled.regen_times.extend(m.regen_times)
        pooled.vulnerability_windows.extend(m.vulnerability_windows)
        pooled.wait_times.extend(m.wait_times)
        pooled.read_latencies.extend(m.read_latencies)
        # dataplane summary keys are conditional on the flag, so a single
        # dataplane member is enough to surface them for the whole pool
        pooled.dataplane = pooled.dataplane or m.dataplane
    return pooled


def bootstrap_cis(members: Sequence[FleetMetrics], keys: Sequence[str],
                  n_boot: int = 200, alpha: float = 0.05,
                  seed: int = 0) -> Dict[str, Tuple[float, float, float]]:
    """Cluster-level bootstrap CIs for pooled summary keys.

    Returns ``{key: (lo, point, hi)}`` where ``point`` is the pooled
    estimate over the real ensemble and ``(lo, hi)`` are the
    ``alpha/2`` / ``1 - alpha/2`` percentiles of ``n_boot`` re-pooled
    resamples (clusters drawn with replacement).  Deterministic in
    ``seed``; an ensemble of identical members yields zero-width
    intervals (every resample is the same multiset — pinned by
    tests/test_ensemble.py).
    """
    if not members:
        raise ValueError("cannot bootstrap an empty ensemble")
    point = pool_metrics(members).summary()
    rng = np.random.default_rng([seed, 0xB007])
    kk = len(members)
    draws: Dict[str, List[float]] = {key: [] for key in keys}
    for _ in range(n_boot):
        idx = rng.integers(0, kk, size=kk)
        s = pool_metrics([members[int(i)] for i in idx]).summary()
        for key in keys:
            draws[key].append(float(s[key]))
    out: Dict[str, Tuple[float, float, float]] = {}
    lo_q, hi_q = 100.0 * (alpha / 2.0), 100.0 * (1.0 - alpha / 2.0)
    for key in keys:
        xs = np.asarray(draws[key], dtype=np.float64)
        if np.isfinite(xs).all():
            lo, hi = (float(np.percentile(xs, lo_q)),
                      float(np.percentile(xs, hi_q)))
        else:                       # e.g. mttdl with zero expected losses
            lo, hi = float(np.min(xs)), float(np.max(xs))
        out[key] = (lo, float(point[key]), hi)
    return out


class ClusterEnsemble:
    """K clusters, one scenario, one lockstep event loop.

    ``policy_factory`` is called once per member so stateful policies
    never share state across clusters (the built-in policies are
    stateless, but the contract should not depend on that).  Every member
    plans on ``device``, as :class:`FleetSimulator` takes it.
    """

    def __init__(self, scenario: Scenario,
                 policy_factory: Callable[[], RepairPolicy],
                 params: CodeParams, clusters: int,
                 root_seed: int = 0, check_shares: bool = False,
                 device: DeviceLike = None):
        if clusters < 1:
            raise ValueError("ensemble needs at least one cluster")
        self.device = resolve_device(device)
        self.scenario = scenario
        self.seeds = [cluster_seed(root_seed, k) for k in range(clusters)]
        self.sims: List[FleetSimulator] = [
            FleetSimulator(scenario, policy_factory(), params, seed=s,
                           check_shares=check_shares, device=self.device)
            for s in self.seeds]
        self.members: Optional[List[FleetMetrics]] = None

    def run(self) -> List[FleetMetrics]:
        """Advance all clusters to the horizon, globally next event first.

        The heap holds ``(next_event_time, member_index)``; ties break
        toward the lower member index (heap tuple order), so the drive
        order is deterministic.  A member whose ``step()`` returns False
        has crossed the horizon and leaves the heap.
        """
        sims = self.sims
        for sim in sims:
            sim.start()
        heap = [(sim.next_event_time(), i) for i, sim in enumerate(sims)]
        heapq.heapify(heap)
        while heap:
            _, i = heapq.heappop(heap)
            sim = sims[i]
            if sim.step():
                heapq.heappush(heap, (sim.next_event_time(), i))
        self.members = [sim.finish() for sim in sims]
        return self.members

    # -- region-level statistics -------------------------------------------

    def pooled(self) -> FleetMetrics:
        if self.members is None:
            self.run()
        return pool_metrics(self.members)

    def cis(self, keys: Sequence[str], n_boot: int = 200,
            alpha: float = 0.05, seed: int = 0,
            ) -> Dict[str, Tuple[float, float, float]]:
        if self.members is None:
            self.run()
        return bootstrap_cis(self.members, keys, n_boot=n_boot,
                             alpha=alpha, seed=seed)
