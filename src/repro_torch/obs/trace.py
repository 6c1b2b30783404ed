"""Flight recorder: a bounded ring buffer of simulation events.

The fleet simulator's metrics collapse a whole run into ~30 end-of-run
scalars; debugging the paper's central claim — regeneration *time* under
heterogeneous links — needs timelines: which link was the bottleneck,
when a tree bypassed it, why a repair missed its promised ETA.  The
:class:`FlightRecorder` is the storage layer for those timelines: the
simulator ``emit()``\\ s one flat dict per lifecycle event (see
``fleet/sim.py`` for the vocabulary) into a ``deque(maxlen=capacity)``,
so a runaway run overwrites its oldest events instead of exhausting
memory (``dropped`` counts the overwritten ones).

Two export formats:

* **JSONL** (:meth:`FlightRecorder.to_jsonl`): a header line carrying
  ``schema_version`` / ``kind`` / run metadata, then one strict-JSON
  object per event — the machine-readable log ``repro_torch.obs.report``
  analyzes.
* **Chrome trace-event JSON** (:meth:`FlightRecorder.to_chrome`):
  repair lifecycles as async span pairs (``queued`` then ``transfer``,
  keyed by the repair id), node down/brownout spans, link occupancy as
  counter tracks, and everything else as instants.  Load the file in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Everything written out passes through :func:`json_sanitize`, which maps
non-finite floats to ``null`` and numpy scalars to Python ones — the
exports (like the bench JSON files) parse under strict
JSON tooling, no ``Infinity`` literals.

Timestamps: events carry simulated seconds; the Chrome export scales to
microseconds (the format's unit), so one simulated second reads as 1 ms
at Perfetto's default zoom.
"""
from __future__ import annotations

import collections
import json
import math
import warnings
from typing import Any, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1
TRACE_KIND = "repro.fleet.trace"

_US = 1e6                         # simulated seconds -> trace microseconds

# Chrome trace "processes" grouping the tracks
_PID_REPAIRS, _PID_NODES, _PID_LINKS, _PID_READS = 1, 2, 3, 4


def json_sanitize(obj: Any) -> Any:
    """Recursively make ``obj`` strict-JSON-safe.

    Non-finite floats become ``None`` (strict JSON has no ``Infinity`` /
    ``NaN`` literals), numpy scalars collapse to Python scalars, tuples
    become lists, and dict keys are stringified when not already str.
    """
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {k if isinstance(k, str) else str(k): json_sanitize(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    item = getattr(obj, "item", None)      # numpy scalars
    if callable(item):
        return json_sanitize(item())
    return obj


class FlightRecorder:
    """Bounded in-memory event log owned by a :class:`FleetSimulator`.

    ``capacity`` bounds memory: past it the oldest events are overwritten
    and ``dropped`` counts how many.  ``meta`` is free-form run metadata
    (seed, scenario, end-of-run summary) carried into every export header.
    """

    def __init__(self, capacity: int = 1 << 16,
                 meta: Optional[Dict[str, Any]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self.meta: Dict[str, Any] = dict(meta or {})
        self._events: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, t: float, ev: str, **attrs: Any) -> None:
        """Record one event at simulated time ``t`` seconds."""
        if len(self._events) == self.capacity:
            if self.dropped == 0:
                # warn once at the first wrap: from here the timeline is a
                # suffix, so a consumer replaying "the whole run" should
                # know the head is gone (the header still counts exactly
                # how many events fell off)
                warnings.warn(
                    f"FlightRecorder ring buffer wrapped at capacity "
                    f"{self.capacity}; oldest events are being dropped "
                    f"(see the 'dropped_events' header field)",
                    RuntimeWarning, stacklevel=2)
            self.dropped += 1
        e = {"t": float(t), "ev": ev}
        e.update(attrs)
        self._events.append(e)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def header(self) -> dict:
        """The export header: schema version, metadata, drop accounting."""
        return json_sanitize({
            "schema_version": SCHEMA_VERSION,
            "kind": TRACE_KIND,
            "capacity": self.capacity,
            "dropped": self.dropped,
            # explicit alias: "dropped" reads ambiguously (dropped what?);
            # consumers should prefer this key, the old one stays for
            # check_trace.py and any external reader already shipped
            "dropped_events": self.dropped,
            "events": len(self._events),
            "meta": self.meta,
        })

    # -- JSONL ------------------------------------------------------------

    def to_jsonl(self) -> str:
        """Header line + one strict-JSON event per line."""
        lines = [json.dumps(self.header(), sort_keys=True,
                            allow_nan=False)]
        for e in self._events:
            lines.append(json.dumps(json_sanitize(e), allow_nan=False))
        return "\n".join(lines) + "\n"

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    # -- Chrome trace-event JSON ------------------------------------------

    def to_chrome(self) -> dict:
        return chrome_trace(self.events, header=self.header())

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, allow_nan=False)


def chrome_trace(events: Iterable[dict],
                 header: Optional[dict] = None) -> dict:
    """Derive a Chrome trace-event object from flight-recorder events.

    Span derivation (async ``b``/``e`` pairs, matched by category + id):

    * ``repair_queued`` opens a ``queued`` span (cat ``repair_wait``, id =
      rid); ``repair_admitted`` closes it and opens the ``transfer`` span
      (cat ``repair``).  ``repair_complete`` / ``repair_abort`` /
      ``repair_evicted`` close ``transfer`` with ``args.reason`` set to
      ``complete`` / ``abort`` / ``evict`` — so the number of ``e``
      events named ``transfer`` with reason in {complete, abort} equals
      the metrics' ``completed + aborted``.
    * ``node_fail`` .. ``node_repaired`` become ``down`` spans and
      ``node_degrade`` .. ``node_recover`` become ``brownout`` spans on
      the nodes process (a re-degrade supersedes: the open span closes).
    * ``read_queued`` .. ``read_complete`` / ``read_abort`` become
      ``read`` spans (cat ``read``) on the reads process — a category
      distinct from ``repair`` so repair-transfer span counting is
      untouched by the data plane.
    * ``link_users`` becomes a per-link counter track (occupancy over
      time); everything else (including ``read_drop`` and
      ``repair_block``) is an instant event.

    Spans still open when the log ends (or whose begin was overwritten by
    the ring buffer) are closed at the last timestamp with
    ``args.unfinished: true`` / silently ignored respectively, so the
    output always loads.
    """
    te: List[dict] = []
    for pid, pname in ((_PID_REPAIRS, "repairs"), (_PID_NODES, "nodes"),
                       (_PID_LINKS, "links"), (_PID_READS, "reads")):
        te.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "ts": 0, "args": {"name": pname}})

    open_spans: Dict[tuple, tuple] = {}   # key -> (name, cat, id, pid, tid)
    last_ts = 0.0

    def begin(key: tuple, name: str, cat: str, ident: Any, pid: int,
              tid: int, ts: float, args: dict) -> None:
        te.append({"ph": "b", "cat": cat, "id": ident, "name": name,
                   "pid": pid, "tid": tid, "ts": ts, "args": args})
        open_spans[key] = (name, cat, ident, pid, tid)

    def end(key: tuple, ts: float, args: dict) -> None:
        info = open_spans.pop(key, None)
        if info is None:        # begin fell off the ring buffer
            return
        name, cat, ident, pid, tid = info
        te.append({"ph": "e", "cat": cat, "id": ident, "name": name,
                   "pid": pid, "tid": tid, "ts": ts, "args": args})

    def instant(name: str, ts: float, tid: int, args: dict,
                pid: int = _PID_REPAIRS, scope: str = "t") -> None:
        te.append({"ph": "i", "name": name, "pid": pid, "tid": tid,
                   "ts": ts, "s": scope, "args": args})

    for e in events:
        ts = e["t"] * _US
        last_ts = max(last_ts, ts)
        ev = e["ev"]
        args = {k: v for k, v in e.items() if k not in ("t", "ev")}
        rid = e.get("rid")
        node = e.get("node", 0)
        if ev == "repair_queued":
            begin(("q", rid), "queued", "repair_wait", rid, _PID_REPAIRS,
                  node, ts, args)
        elif ev == "repair_admitted":
            end(("q", rid), ts, {})
            begin(("x", rid), "transfer", "repair", rid, _PID_REPAIRS,
                  node, ts, args)
        elif ev == "repair_complete":
            end(("x", rid), ts, dict(args, reason="complete"))
        elif ev == "repair_abort":
            end(("x", rid), ts, dict(args, reason="abort"))
        elif ev == "repair_evicted":
            end(("x", rid), ts, dict(args, reason="evict"))
        elif ev == "node_fail":
            begin(("down", node), "down", "node_down", node, _PID_NODES,
                  node, ts, args)
        elif ev == "node_repaired":
            end(("down", node), ts, args)
        elif ev == "node_degrade":
            end(("brownout", node), ts, {"superseded": True})
            begin(("brownout", node), "brownout", "node_brownout", node,
                  _PID_NODES, node, ts, args)
        elif ev == "node_recover":
            end(("brownout", node), ts, args)
        elif ev == "read_queued":
            # data-plane reads: span per read on the reads
            # process, cat "read" — deliberately NOT "repair" so
            # finished-transfer counting stays a pure repair invariant
            begin(("r", e.get("rdid")), "read", "read", e.get("rdid"),
                  _PID_READS, e.get("dst", 0), ts, args)
        elif ev == "read_complete":
            end(("r", e.get("rdid")), ts, dict(args, reason="complete"))
        elif ev == "read_abort":
            end(("r", e.get("rdid")), ts, dict(args, reason="abort"))
        elif ev == "link_users":
            te.append({"ph": "C", "name": f"link {e['src']}->{e['dst']}",
                       "pid": _PID_LINKS, "tid": 0, "ts": ts,
                       "args": {"users": e["users"]}})
        elif ev in ("data_loss", "capacity_shock", "estimate_refresh"):
            instant(ev, ts, 0, args, scope="g")
        else:   # repair_deferred, repair_replan, watchdog_*, future events
            instant(ev, ts, node, args)

    for key in sorted(open_spans, key=str):
        end(key, last_ts, {"unfinished": True})

    return json_sanitize({
        "traceEvents": te,
        "displayTimeUnit": "ms",
        "otherData": header or {},
    })


def finished_transfer_spans(trace: dict,
                            reasons: tuple = ("complete", "abort"),
                            ) -> int:
    """Count closed transfer spans by reason in a Chrome trace object.

    With the default reasons this is the span count the acceptance check
    compares against ``completed + aborted``.
    """
    return sum(1 for e in trace.get("traceEvents", ())
               if e.get("ph") == "e" and e.get("name") == "transfer"
               and e.get("args", {}).get("reason") in reasons)
