"""Scenario layer: failure processes, capacity models, and load, composed.

A :class:`Scenario` is pure configuration — everything stochastic is drawn
inside the simulator from named child streams of one root seed, so a
scenario replayed with the same seed is bitwise reproducible.

Capacity models reuse the repo's existing samplers rather than inventing
new ones: ``repro_torch.storage.capacities.uniform_matrix`` gives the paper's
PlanetLab-style i.i.d. regime at cluster scale, and ``tiered_capacities``
wraps ``repro_torch.ft.topology.Fleet`` so the TPU-fleet two-tier (intra-pod /
cross-pod DCN + stragglers) topology drives fleet simulations too.

``SCENARIOS`` is the library the benchmarks sweep: steady-state Poisson
churn, rack-correlated failure bursts, capacity weather (periodic
background-traffic shocks), and degraded-read pressure.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..storage.capacities import ClusterCapSampler, uniform_matrix

from .dataplane import ReadTrace


def tiered_capacities(num_pods: int = 2, hosts_per_pod: int = 0,
                      block_mb: float = 64.0,
                      straggler_fraction: float = 0.05,
                      ) -> ClusterCapSampler:
    """TPU-fleet two-tier capacities via ``repro_torch.ft.topology.Fleet``.

    ``hosts_per_pod = 0`` derives the pod size from the cluster size n at
    sample time (ceil(n / num_pods)).  The Fleet's straggler assignment is
    seeded from the scenario's capacity stream, keeping determinism.
    """

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        from ..ft import Fleet, FleetConfig

        hpp = hosts_per_pod or -(-n // num_pods)
        fleet = Fleet(FleetConfig(num_pods=num_pods, hosts_per_pod=hpp,
                                  straggler_fraction=straggler_fraction),
                      seed=int(rng.integers(1 << 31)))
        return np.asarray(
            fleet.capacity_matrix(list(range(n)), block_mb=block_mb, rng=rng))

    return sample


# (failed slot, healthy nodes, rng) -> provider ids; None = uniform sample
ProviderPicker = Callable[[int, List[int], np.random.Generator], List[int]]

# (time, node) pairs injected on top of / instead of the Poisson process
InjectedFailure = Tuple[float, int]

# (time, node, factor, duration): at ``time`` the node's outgoing link
# rates are multiplied by ``factor`` in [0, 1) (0.0 = full stall) for
# ``duration`` seconds — deterministic straggler injections for tests,
# on top of / instead of the Markov degrade process
InjectedDegrade = Tuple[float, int, float, float]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Composable description of a fleet workload.

    Rates are per *second* of simulated time; capacities are blocks/sec as
    everywhere else in the repo.
    """

    num_nodes: int
    duration: float
    # -- failure process ----------------------------------------------------
    failure_rate: float = 0.0         # per healthy node, Poisson
    rack_size: int = 0                # 0 = no rack structure
    rack_burst_prob: float = 0.0      # P(failure is a correlated rack burst)
    rack_burst_extra: int = 1         # extra victims per burst, same rack
    failures: Tuple[InjectedFailure, ...] = ()   # deterministic injections
    # -- capacities ---------------------------------------------------------
    capacity_model: ClusterCapSampler = uniform_matrix()
    shock_period: float = 0.0         # 0 = static capacities
    shock_lo: float = 1.0             # per-link multiplier bounds applied to
    shock_hi: float = 1.0             # the base matrix at every shock
    # -- degraded-read load -------------------------------------------------
    read_rate: float = 0.0            # arrivals/sec while any slot is down
    read_duration: float = 1.0        # seconds each read occupies its links
    read_fanin: int = 0               # links per read; 0 = params.k
    # -- repair admission ---------------------------------------------------
    max_concurrent: int = 4
    provider_picker: Optional[ProviderPicker] = None
    # -- repair lifecycle (both OFF by default: the default path reproduces
    #    the default dynamics bitwise) -------------------------------------
    carryover: bool = False           # keep banked blocks on provider-loss
    #                                   aborts; credit them at re-admission
    migration: bool = False           # offer in-flight repairs a re-plan at
    #                                   capacity-shock / provider-loss epochs
    bank_aware_migration: bool = False    # score every candidate replan by
    #                                   *credited* residual ETA (banked
    #                                   blocks subtracted) instead of taking
    #                                   the policy's nominal-time pick —
    #                                   prefers trees overlapping
    #                                   already-banked links
    # -- plan-vs-reality robustness (everything OFF by default:
    #    the default path reproduces the pre-robustness dynamics bitwise) --
    estimate_noise: float = 0.0       # relative noise on each believed
    #                                   capacity snapshot, U[1-e, 1+e]
    estimate_refresh_period: float = 0.0  # seconds between believed-matrix
    #                                   snapshots; 0 = refresh every event
    #                                   epoch (fresh but noisy).  Estimate
    #                                   error is on iff noise > 0 or
    #                                   refresh period > 0
    degrade_rate: float = 0.0         # per-node Poisson rate of silent
    #                                   outgoing-link brownouts
    degrade_mean_duration: float = 0.0    # mean brownout length (Exp)
    degrade_lo: float = 0.0           # brownout rate-multiplier bounds,
    degrade_hi: float = 0.0           # drawn U[lo, hi] in [0, 1)
    degradations: Tuple[InjectedDegrade, ...] = ()  # deterministic stalls
    watchdog_period: float = 0.0      # progress-check interval; 0 = no
    #                                   watchdog (no mitigation)
    watchdog_lag: float = 2.0         # flag a repair once its banked
    #                                   progress falls below 1/lag of the
    #                                   plan-predicted trajectory
    watchdog_retries: int = 3         # straggler evictions per repair
    #                                   before the watchdog gives up
    watchdog_backoff: float = 2.0     # exponential re-check backoff base
    degraded_d: bool = False          # admit with d' in [k, d) helpers when
    #                                   fewer than d are healthy (functional
    #                                   repair stays sound for any d >= k)
    # -- observability (OFF by default: with trace off the
    #    simulator allocates no recorder and the default path stays
    #    bitwise identical — tracing is observation, not perturbation) ----
    trace: bool = False               # own a FlightRecorder + link tracer
    trace_capacity: int = 1 << 16     # ring-buffer size (oldest events are
    #                                   overwritten past it, counted as
    #                                   dropped)
    # -- coded data plane (OFF by default: with dataplane off the
    #    simulator allocates no coded store, consumes no extra rng, and the
    #    default path stays bitwise identical) -----------------------------
    dataplane: bool = False           # reads become k fragment transfers
    #                                   through fair-share contention
    #                                   (read_duration is ignored) and every
    #                                   completed repair replays its plan on
    #                                   a real RLNC-coded store
    dataplane_block_bytes: float = 64 * 1024 * 1024   # wire bytes per code
    #                                   block (64 MiB, matching the tiered
    #                                   topology's block_mb)
    dataplane_blocks: int = 0         # mini-code file size M for the coded
    #                                   store; 0 = 2k.  Must be divisible by
    #                                   k (integral alpha)
    dataplane_payload_bytes: int = 8  # GF payload bytes per stored block
    dataplane_matmul: str = "auto"    # GF matmul backend for the store:
    #                                   auto | kernel | numpy (see
    #                                   DataPlane._resolve_matmul)
    dataplane_verify: bool = False    # decode-check (can_reconstruct) after
    #                                   every completed repair
    read_trace: Optional[ReadTrace] = None    # open-loop read arrivals
    #                                   (requires dataplane=True); served
    #                                   whenever >= fanin + 1 nodes are
    #                                   healthy, dropped + counted otherwise

    def __post_init__(self):
        if self.num_nodes < 2:
            raise ValueError("need at least 2 nodes")
        if self.duration <= 0:
            raise ValueError("duration must be positive")
        if self.shock_period < 0 or self.failure_rate < 0 or self.read_rate < 0:
            raise ValueError("rates/periods must be non-negative")
        if self.read_duration <= 0:
            raise ValueError("read_duration must be positive")
        if self.shock_lo < 0 or self.shock_hi < self.shock_lo:
            raise ValueError("need 0 <= shock_lo <= shock_hi")
        if self.max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {self.max_concurrent}: "
                f"an admission budget of zero can never start a repair")
        if not 0.0 <= self.rack_burst_prob <= 1.0:
            raise ValueError(
                f"rack_burst_prob must be a probability in [0, 1], got "
                f"{self.rack_burst_prob}")
        if self.rack_burst_extra < 0:
            raise ValueError(
                f"rack_burst_extra must be >= 0, got {self.rack_burst_extra}")
        if self.read_fanin < 0:
            raise ValueError(
                f"read_fanin must be >= 0 (0 = params.k), got "
                f"{self.read_fanin}")
        if not 0.0 <= self.estimate_noise < 1.0:
            raise ValueError(
                f"estimate_noise must be in [0, 1), got "
                f"{self.estimate_noise}: noise >= 1 lets a believed "
                f"capacity hit zero on a live link")
        if self.estimate_refresh_period < 0:
            raise ValueError("estimate_refresh_period must be non-negative")
        if self.degrade_rate < 0:
            raise ValueError("degrade_rate must be non-negative")
        if self.degrade_rate > 0 and self.degrade_mean_duration <= 0:
            raise ValueError(
                "degrade_rate > 0 needs degrade_mean_duration > 0")
        if not 0.0 <= self.degrade_lo <= self.degrade_hi:
            raise ValueError("need 0 <= degrade_lo <= degrade_hi")
        if self.degrade_hi >= 1.0:
            raise ValueError(
                f"degrade factors must stay below 1, got degrade_hi="
                f"{self.degrade_hi}: a multiplier >= 1 is not a brownout")
        for inj in self.degradations:
            t, node, factor, dur = inj
            if not (0.0 <= factor < 1.0) or dur <= 0 or t < 0:
                raise ValueError(
                    f"bad degradation injection {inj}: need time >= 0, "
                    f"factor in [0, 1), duration > 0")
        if self.watchdog_period < 0:
            raise ValueError("watchdog_period must be non-negative")
        if self.watchdog_lag < 1.0:
            raise ValueError(
                f"watchdog_lag must be >= 1, got {self.watchdog_lag}: a "
                f"threshold below 1 flags repairs that are on schedule")
        if self.watchdog_retries < 0:
            raise ValueError("watchdog_retries must be non-negative")
        if self.watchdog_backoff < 1.0:
            raise ValueError(
                f"watchdog_backoff must be >= 1, got "
                f"{self.watchdog_backoff}: a base below 1 re-checks "
                f"faster after every failure")
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {self.trace_capacity}")
        if self.dataplane and self.read_fanin > self.num_nodes - 1:
            raise ValueError(
                f"read_fanin={self.read_fanin} exceeds the {self.num_nodes - 1} "
                f"possible helpers of an {self.num_nodes}-node cluster: with "
                f"dataplane=True every read needs fanin live sources besides "
                f"its destination, so such a read could never be served")
        if self.read_trace is not None and not self.dataplane:
            raise ValueError(
                "read_trace= is an open-loop data-plane workload and needs "
                "dataplane=True (the legacy phantom-read path is closed-loop "
                "via read_rate and only fires while a slot is down)")
        if self.dataplane:
            if self.dataplane_block_bytes <= 0:
                raise ValueError("dataplane_block_bytes must be positive")
            if self.dataplane_payload_bytes < 1:
                raise ValueError("dataplane_payload_bytes must be >= 1")
            if self.dataplane_blocks < 0:
                raise ValueError("dataplane_blocks must be >= 0 (0 = 2k)")
            if self.dataplane_matmul not in ("auto", "kernel", "numpy"):
                raise ValueError(
                    f"dataplane_matmul must be auto|kernel|numpy, got "
                    f"{self.dataplane_matmul!r}")


# ---------------------------------------------------------------------------
# Scenario library (n-parameterized factories the benchmarks sweep)
# ---------------------------------------------------------------------------

def steady(n: int, failure_rate: float = 2e-3,
           duration: float = 20_000.0) -> Scenario:
    """Steady Poisson churn over static PlanetLab-style capacities."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate)


def rack_bursts(n: int, failure_rate: float = 2e-3,
                duration: float = 20_000.0) -> Scenario:
    """Rack-correlated bursts: 30% of failures take out a rack neighbour
    too, stressing the window-of-vulnerability accounting."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    rack_size=max(n // 4, 2), rack_burst_prob=0.3,
                    rack_burst_extra=1)


def capacity_weather(n: int, failure_rate: float = 2e-3,
                     duration: float = 20_000.0,
                     shock_period: float = 500.0, shock_lo: float = 0.25,
                     cap_lo: float = 10.0, cap_hi: float = 120.0) -> Scenario:
    """Background-traffic weather: every ``shock_period`` seconds each
    link's capacity is rescaled by an independent U[shock_lo, 1]
    multiplier.  The storm knobs (fast, deep shocks over slow links) put
    in-flight repairs under weather that outlives their plans — the
    regime plan migration is for."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    capacity_model=uniform_matrix(cap_lo, cap_hi),
                    shock_period=shock_period, shock_lo=shock_lo,
                    shock_hi=1.0)


def hot_reads(n: int, failure_rate: float = 2e-3,
              duration: float = 20_000.0, dataplane: bool = False,
              read_trace: Optional[ReadTrace] = None,
              dataplane_verify: bool = False) -> Scenario:
    """Degraded-read pressure: while any slot is down, reconstruction reads
    arrive and contend with repairs for the same links.

    With ``dataplane=True`` the reads become real fragment transfers
   ; passing a ``read_trace`` switches to the open-loop
    trace-driven workload and turns the closed-loop ``read_rate`` off.
    The defaults leave both off, so the golden rows are untouched."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    read_rate=0.0 if read_trace is not None else 0.05,
                    read_duration=20.0, dataplane=dataplane,
                    read_trace=read_trace, dataplane_verify=dataplane_verify)


def tiered(n: int, failure_rate: float = 2e-3,
           duration: float = 20_000.0) -> Scenario:
    """TPU-fleet tiered capacities (repro_torch.ft.topology) under steady
    churn."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    capacity_model=tiered_capacities())


def flaky_providers(n: int, failure_rate: float = 4e-3,
                    duration: float = 2_500.0) -> Scenario:
    """Provider-loss stress: slow links stretch regenerations onto the same
    timescale as the failure process, so in-flight repairs frequently lose
    a provider mid-transfer — the abort / partial-progress-carryover /
    migration path.  Pair with ``dataclasses.replace(sc, carryover=True,
    migration=True)`` to measure how much of the vulnerability window the
    lifecycle machinery claws back."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    capacity_model=uniform_matrix(0.3, 8.0),
                    max_concurrent=8)


def stragglers(n: int, failure_rate: float = 2e-3,
               duration: float = 4_000.0) -> Scenario:
    """Silent straggler/stall pressure: nodes' outgoing links brown out to
    a U[0, 0.1] multiplier (often a near-full stall) for minutes at a time
    *without the host dying* — the fault class the provider-loss abort
    path cannot see.  Today's simulator silently waits out a stalled link;
    pair with :func:`mitigated` to measure what the watchdog + eviction +
    degraded-d stack claws back."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    capacity_model=uniform_matrix(2.0, 40.0),
                    degrade_rate=1e-3, degrade_mean_duration=400.0,
                    degrade_lo=0.0, degrade_hi=0.1,
                    max_concurrent=8)


def foggy_estimates(n: int, failure_rate: float = 2e-3,
                    duration: float = 4_000.0) -> Scenario:
    """Stale, noisy capacity estimates under weather: the believed matrix
    policies plan against is a U[1-0.35, 1+0.35]-noised snapshot refreshed
    every 300 s, while the true capacities are re-shocked every 120 s —
    predicted and realized ETAs diverge (the plan-error distribution in
    the metrics).  Pair with :func:`mitigated` to let the watchdog rescue
    the worst-planned repairs."""
    return Scenario(num_nodes=n, duration=duration,
                    failure_rate=failure_rate,
                    capacity_model=uniform_matrix(1.0, 30.0),
                    shock_period=120.0, shock_lo=0.2, shock_hi=1.0,
                    estimate_noise=0.35, estimate_refresh_period=300.0,
                    max_concurrent=8)


def mitigated(sc: Scenario, watchdog_period: float = 25.0) -> Scenario:
    """The robustness mitigation stack ON for A/B comparisons: progress
    watchdog (replan -> straggler eviction with retry/backoff), banked-
    block carryover so evictions keep received work, and degraded-d
    admission so repairs stop queueing forever when fewer than d helpers
    are healthy.  The scenario's fault injection knobs are left as-is."""
    return dataclasses.replace(sc, carryover=True, degraded_d=True,
                               watchdog_period=watchdog_period)


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "steady": steady,
    "rack_bursts": rack_bursts,
    "capacity_weather": capacity_weather,
    "hot_reads": hot_reads,
    "tiered": tiered,
    "flaky_providers": flaky_providers,
    "stragglers": stragglers,
    "foggy_estimates": foggy_estimates,
}
