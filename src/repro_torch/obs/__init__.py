"""Observability: flight recorder, link/node timelines, planner profiling.

The subsystem is strictly opt-in and zero-overhead when off: the fleet
simulator only allocates a :class:`FlightRecorder` when
``Scenario.trace`` is set, the planning core only calls into a
:class:`PlannerProfile` when one is passed as ``plan(..., profile=)``,
and neither path touches any rng stream — tracing is observation, not
perturbation (the goldens pin this bitwise).

The trace schema and kind are the reference's (``repro.obs``), so each
package's ``report`` reads the other's traces; ``repro_torch.obs.report``
is the analysis CLI.
"""
from .profile import PlannerProfile
from .timeline import LinkUsageTracer
from .trace import (FlightRecorder, SCHEMA_VERSION, TRACE_KIND,
                    chrome_trace, finished_transfer_spans, json_sanitize)

__all__ = [
    "FlightRecorder", "LinkUsageTracer", "PlannerProfile",
    "SCHEMA_VERSION", "TRACE_KIND", "chrome_trace",
    "finished_transfer_spans", "json_sanitize",
]
