"""Observability: spans and counters on the profiler's clock, flight
recorder, link/node timelines, planner profiling.

Spans and counters (:mod:`.spans`) sit at the port's layer boundaries: a
plan (``plan.many``) and its planner's stages (``plan.<scheme>.<stage>``),
the planner's device reads by site (counters ``plan.reads.<site>``), a
repair's execution (``repair.execute``, ``rlnc.*``), each GF(2^8) product
(``gf.matmul``, counter ``gf.launches``), the train step (``train.eager``,
``train.capture``, ``train.replay``, ``train.release``) and a checkpoint
save (``ckpt.save``, ``ckpt.flatten``, ``ckpt.encode``).  They are on
exactly while ``torch.profiler`` records, and then cost one
``record_function`` each; off, a span is one flag test.  An operator who
runs ``torch.profiler.profile`` around the program gets these spans in the
trace, nested over the aten calls and kernels they launched (the idle gaps
between kernels name the program stage the host was in), and
``spans.summary()`` gives their tallies over the profiled part: calls,
host ms and self ms per span, each counter's traced total, and the
kernel's device ms per product shape.  Counter totals are kept always.

The rest is strictly opt-in and zero-overhead when off: the fleet
simulator only allocates a :class:`FlightRecorder` when ``Scenario.trace``
is set, the planning core only calls into a :class:`PlannerProfile` when
one is passed as ``plan(..., profile=)``, and neither path touches any rng
stream — tracing is observation, not perturbation (the goldens pin this
bitwise).

The trace schema and kind are the reference's (``repro.obs``), so each
package's ``report`` reads the other's traces; ``repro_torch.obs.report``
is the analysis CLI.  ``__all__`` is the reference's (the tests hold the
two surfaces equal); ``spans`` is the port's own module beside it.
"""
from . import spans  # noqa: F401  (the port's own: not in __all__)
from .profile import PlannerProfile
from .timeline import LinkUsageTracer
from .trace import (FlightRecorder, SCHEMA_VERSION, TRACE_KIND,
                    chrome_trace, finished_transfer_spans, json_sanitize)

__all__ = [
    "FlightRecorder", "LinkUsageTracer", "PlannerProfile",
    "SCHEMA_VERSION", "TRACE_KIND", "chrome_trace",
    "finished_transfer_spans", "json_sanitize",
]
