"""Fleet simulator: event-driven cluster regeneration under contention.

The paper evaluates one regeneration at a time on one sampled overlay; a
production fleet repairs continuously, and concurrent regenerations share
the same heterogeneous links.  This package simulates an n-slot
erasure-coded cluster over simulated time — Poisson (optionally
rack-correlated) failures, a repair queue, fair-share link contention,
pluggable per-repair scheme policies backed by the batched planning
engine — and reports fleet metrics (backlog, p50/p99 regeneration time
under contention, window of vulnerability, MTTDL estimate) that
single-repair Monte Carlo cannot produce.  It is the counterpart of
``repro.fleet``: the event loop and the models are host code, the same
float arithmetic in the same order; planning runs on the simulator's
device through ``repro_torch.core.plan_many``, and the coded data plane's
store is held there, its products going through the GF(2^8) matmul kernel.
"""
from .cluster import ClusterState, FAILED, HEALTHY, REPAIRING
from .dataplane import DataPlane, ReadTrace, generate_trace
from .ensemble import (ClusterEnsemble, bootstrap_cis, cluster_seed,
                       pool_metrics)
from .events import Event, EventQueue
from .metrics import FleetMetrics
from .policy import FixedPolicy, FlexiblePolicy, RepairPolicy, make_policy
from .scenario import (SCENARIOS, Scenario, capacity_weather,
                       flaky_providers, foggy_estimates, hot_reads,
                       mitigated, rack_bursts, steady, stragglers, tiered,
                       tiered_capacities)
from .sharing import ActiveRepair, LinkShareModel, apply_credit, plan_links
from .sim import FleetSimulator, QueuedRepair, simulate

__all__ = [
    "ActiveRepair", "ClusterEnsemble", "ClusterState", "DataPlane",
    "Event", "EventQueue", "FAILED", "FleetMetrics", "FleetSimulator",
    "FixedPolicy", "FlexiblePolicy", "HEALTHY", "LinkShareModel",
    "QueuedRepair", "REPAIRING", "ReadTrace", "RepairPolicy", "SCENARIOS",
    "Scenario", "apply_credit", "bootstrap_cis", "capacity_weather",
    "cluster_seed", "flaky_providers", "foggy_estimates", "generate_trace",
    "hot_reads", "make_policy", "mitigated", "plan_links", "pool_metrics",
    "rack_bursts", "simulate", "steady", "stragglers", "tiered",
    "tiered_capacities",
]
