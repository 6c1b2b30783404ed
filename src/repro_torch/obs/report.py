"""Analyses over a flight-recorder JSONL trace.

Loads the event log ``FlightRecorder.to_jsonl`` wrote and answers the
questions the end-of-run scalars cannot:

* :func:`top_bottleneck_links` — which directed links carried the most
  contention (user-seconds) and how saturated they ran;
* :func:`watchdog_funnel` — the mitigation ladder as a funnel: flags ->
  rescue replans -> straggler evictions -> give-ups;
* :func:`plan_error_attribution` — which bottleneck links the late
  repairs (realized >> predicted ETA) completed on, with the excess
  seconds attributed per link;
* :func:`node_brownout_timeline` — per-node degrade episodes and total
  degraded time;
* :func:`top_links_by_bytes` — which links moved the most data-plane
  bytes (coded repair blocks + degraded-read fragments).

Run as a module for a text report::

    python -m repro_torch.obs.report trace.jsonl [--top 10]

All analyses are defensive about the ring buffer: per-link aggregates
prefer the exact integrals the simulator stored in the header
(``meta.links``, accumulated online by ``LinkUsageTracer``) and fall
back to reconstructing from ``link_users`` events only when absent.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

from .trace import TRACE_KIND


def load_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Read a flight-recorder JSONL file -> (header, events)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header = json.loads(lines[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a flight-recorder trace "
                         f"(kind={header.get('kind')!r})")
    return header, [json.loads(ln) for ln in lines[1:]]


def _derive_link_stats(events: List[dict], t_end: float) -> dict:
    """Reconstruct per-link aggregates from ``link_users`` events (the
    fallback when the header carries no ``meta.links`` snapshot)."""
    users: Dict[str, int] = {}
    since: Dict[str, float] = {}
    out: Dict[str, dict] = {}

    def integrate(key: str, t: float) -> None:
        prev = users.get(key, 0)
        if prev > 0:
            dt = t - since[key]
            if dt > 0:
                cell = out.setdefault(key, {"busy_time": 0.0,
                                            "user_seconds": 0.0,
                                            "max_users": 0})
                cell["busy_time"] += dt
                cell["user_seconds"] += prev * dt

    for e in events:
        if e["ev"] != "link_users":
            continue
        key = f"{e['src']}->{e['dst']}"
        integrate(key, e["t"])
        if e["users"] > 0:
            users[key] = e["users"]
            since[key] = e["t"]
            cell = out.setdefault(key, {"busy_time": 0.0,
                                        "user_seconds": 0.0,
                                        "max_users": 0})
            cell["max_users"] = max(cell["max_users"], e["users"])
        else:
            users.pop(key, None)
            since.pop(key, None)
    for key in list(users):
        integrate(key, t_end)
    return out


def link_stats(header: dict, events: List[dict]) -> dict:
    """Per-link ``{"src->dst": {busy_time, user_seconds, max_users}}``."""
    meta = header.get("meta", {})
    snap = meta.get("links")
    if snap and snap.get("links"):
        return snap["links"]
    t_end = meta.get("duration") or max((e["t"] for e in events),
                                        default=0.0)
    return _derive_link_stats(events, t_end)


def top_bottleneck_links(header: dict, events: List[dict],
                         k: int = 10) -> List[Tuple[str, dict]]:
    """The ``k`` links with the most user-seconds (contention), sorted."""
    stats = link_stats(header, events)
    return sorted(stats.items(),
                  key=lambda kv: (-kv[1]["user_seconds"], kv[0]))[:k]


def link_bytes(header: dict, events: List[dict]) -> dict:
    """Per-link data-plane wire bytes:
    ``{"src->dst": {"repair_bytes": x, "read_bytes": y}}``.

    Prefers the exact ledger the simulator stored in the header
    (``meta.dataplane.links``, written by ``DataPlane.snapshot``); falls
    back to summing ``repair_block`` events when the snapshot is absent
    (read bytes cannot be reconstructed that way — ``read_complete``
    carries a total, not per-link splits — so the fallback reports
    repair bytes only).  Empty dict when the run had no data plane.
    """
    meta = header.get("meta", {})
    snap = meta.get("dataplane")
    if snap and snap.get("links"):
        return snap["links"]
    out: Dict[str, dict] = {}
    for e in events:
        if e["ev"] != "repair_block":
            continue
        key = f"{e['producer']}->{e['dst']}"
        cell = out.setdefault(key, {"repair_bytes": 0.0, "read_bytes": 0.0})
        cell["repair_bytes"] += e["bytes"]
    return out


def top_links_by_bytes(header: dict, events: List[dict],
                       k: int = 10) -> List[Tuple[str, dict]]:
    """The ``k`` links that moved the most data-plane bytes (repair +
    read), sorted heaviest first, name-tiebroken."""
    stats = link_bytes(header, events)
    return sorted(
        stats.items(),
        key=lambda kv: (-(kv[1].get("repair_bytes", 0.0)
                          + kv[1].get("read_bytes", 0.0)), kv[0]))[:k]


def watchdog_funnel(events: List[dict]) -> dict:
    """The mitigation ladder as a funnel of event counts."""
    return {
        "flags": sum(1 for e in events if e["ev"] == "watchdog_flag"),
        "replans": sum(1 for e in events if e["ev"] == "repair_replan"
                       and e.get("kind") == "watchdog"),
        "evictions": sum(1 for e in events if e["ev"] == "repair_evicted"),
        "giveups": sum(1 for e in events if e["ev"] == "watchdog_giveup"),
    }


def plan_error_attribution(events: List[dict],
                           k: int = 10) -> List[dict]:
    """Attribute realized-vs-predicted ETA error to bottleneck links.

    Groups ``repair_complete`` events (those with a finite prediction) by
    the bottleneck link they finished on; per link, sums the excess
    seconds (realized - predicted, clamped at 0) and averages the
    relative plan error.  Sorted by excess, worst first.
    """
    groups: Dict[str, dict] = {}
    for e in events:
        if e["ev"] != "repair_complete" or e.get("plan_err") is None:
            continue
        bn = e.get("bottleneck")
        key = f"{bn[0]}->{bn[1]}" if bn else "(none)"
        cell = groups.setdefault(key, {"link": key, "repairs": 0,
                                       "excess_seconds": 0.0,
                                       "err_sum": 0.0})
        cell["repairs"] += 1
        cell["excess_seconds"] += max(0.0, e["realized"] - e["predicted"])
        cell["err_sum"] += e["plan_err"]
    out = []
    for cell in groups.values():
        cell["mean_plan_err"] = cell.pop("err_sum") / cell["repairs"]
        out.append(cell)
    out.sort(key=lambda c: (-c["excess_seconds"], c["link"]))
    return out[:k]


def node_brownout_timeline(events: List[dict],
                           t_end: Optional[float] = None) -> dict:
    """Per-node brownout episodes ``[start, factor, end-or-None]`` plus
    total degraded seconds (open episodes count up to ``t_end``)."""
    if t_end is None:
        t_end = max((e["t"] for e in events), default=0.0)
    nodes: Dict[int, dict] = {}

    def close(node: int, t: float) -> None:
        cell = nodes.get(node)
        if cell and cell["episodes"] and cell["episodes"][-1][2] is None:
            ep = cell["episodes"][-1]
            ep[2] = t
            cell["degraded_time"] += t - ep[0]

    for e in events:
        if e["ev"] == "node_degrade":
            close(e["node"], e["t"])        # re-degrade supersedes
            cell = nodes.setdefault(e["node"], {"episodes": [],
                                                "degraded_time": 0.0})
            cell["episodes"].append([e["t"], e["factor"], None])
        elif e["ev"] == "node_recover":
            close(e["node"], e["t"])
    for node in nodes:
        close(node, t_end)
    return nodes


def render_report(header: dict, events: List[dict], top: int = 10) -> str:
    """Human-readable text report over one trace."""
    meta = header.get("meta", {})
    lines = [
        f"flight recorder: {header.get('events', len(events))} events "
        f"({header.get('dropped', 0)} dropped), "
        f"seed={meta.get('seed')}, config={meta.get('config', '?')}",
        "",
        f"top {top} bottleneck links (user-seconds of contention):",
    ]
    for key, st in top_bottleneck_links(header, events, top):
        lines.append(f"  {key:>10}  busy {st['busy_time']:10.1f}s  "
                     f"user-s {st['user_seconds']:10.1f}  "
                     f"peak users {st['max_users']}")
    dp_bytes = top_links_by_bytes(header, events, top)
    if dp_bytes:
        lines += ["", f"top {min(top, len(dp_bytes))} links by data-plane "
                  "bytes (repair + read):"]
        for key, st in dp_bytes:
            rb = st.get("repair_bytes", 0.0)
            db = st.get("read_bytes", 0.0)
            lines.append(f"  {key:>10}  repair {rb / 1e9:10.3f} GB  "
                         f"read {db / 1e9:10.3f} GB")
    funnel = watchdog_funnel(events)
    lines += ["", "watchdog funnel: "
              f"{funnel['flags']} flagged -> {funnel['replans']} replanned "
              f"-> {funnel['evictions']} evicted -> "
              f"{funnel['giveups']} given up"]
    attribution = plan_error_attribution(events, top)
    if attribution:
        lines += ["", "plan-error attribution (late repairs by "
                  "bottleneck link):"]
        for cell in attribution:
            lines.append(f"  {cell['link']:>10}  {cell['repairs']:4d} "
                         f"repairs  excess {cell['excess_seconds']:9.1f}s  "
                         f"mean err {cell['mean_plan_err']:+.2f}")
    brown = node_brownout_timeline(events, meta.get("duration"))
    if brown:
        lines += ["", "node brownouts:"]
        for node in sorted(brown):
            cell = brown[node]
            lines.append(f"  node {node:3d}  {len(cell['episodes'])} "
                         f"episodes  degraded {cell['degraded_time']:.1f}s")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a text report from a flight-recorder JSONL "
                    "trace")
    ap.add_argument("trace", help="path to a .jsonl trace file")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per ranking (default 10)")
    args = ap.parse_args(argv)
    header, events = load_jsonl(args.trace)
    print(render_report(header, events, args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
