#!/usr/bin/env python3
"""The planning tier's device-to-host reads by call site, and its stages'
host time, read from the program's own spans and counters.

    python3 scripts/plan_reads.py [--device cuda] [--seed N] [--out FILE]

Plans FTR at the fig6-msr-d10 deployment (MSR n=20, k=5, d=10, M=240,
links U[10,120]) at B = 1 (``--overlays`` calls of one overlay each) and
at B = 4,096 (one call), each warm and under ``torch.profiler``, and
reports for each the traced counters ``plan.reads.<site>`` a call, their
sum beside ``torch_engine.syncs``' move, and the spans' calls, ms and self
ms (``repro_torch.obs.spans.summary()``).  Prints the card (or the host)
first and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, D, M = 20, 5, 10, 240.0


def caps_of(rng: np.random.Generator, count: int) -> np.ndarray:
    caps = rng.uniform(10.0, 120.0, size=(count, D + 1, D + 1))
    caps[:, np.arange(D + 1), np.arange(D + 1)] = 0.0
    return caps


def traced(batches, params, dev, core, te, spans) -> dict:
    """Plan each batch once under the profiler; the tallies a call."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    spans.reset()
    syncs = te.syncs
    sync()
    with torch.profiler.profile(activities=acts):
        for caps in batches:
            core.plans_from_batch(core.plan_many(caps, params, "ftr",
                                                 device=dev), params)
        sync()
    summary = spans.summary()
    calls = len(batches)
    sites = {name[len("plan.reads."):]: c["traced"] / calls
             for name, c in sorted(summary["counters"].items(),
                                   key=lambda kv: -kv[1]["traced"])
             if name.startswith("plan.reads.")}
    engine = sum(v for s, v in sites.items() if s not in ("profile",
                                                          "unpack"))
    return {"calls": calls, "B": int(batches[0].shape[0]),
            "reads_a_call": sites, "engine_reads_a_call": engine,
            "syncs_a_call": (te.syncs - syncs) / calls,
            "spans": {n: {"calls": s["calls"] / calls,
                          "ms": s["ms"] / calls,
                          "self_ms": s["self_ms"] / calls}
                      for n, s in summary["spans"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--overlays", type=int, default=20)
    ap.add_argument("--bulk", type=int, default=4096)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("plan_reads: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.core import torch_engine as te
    from repro_torch.obs import spans

    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    else:
        print("host", flush=True)
    params = core.CodeParams.msr(n=N, k=K, d=D, M=M)
    rng = np.random.default_rng(args.seed)
    ones = [torch.from_numpy(caps_of(rng, 1)).to(dev)
            for _ in range(args.overlays)]
    bulk = [torch.from_numpy(caps_of(rng, args.bulk)).to(dev)]
    for caps in (ones[0], bulk[0]):               # warm both shapes
        core.plan_many(caps, params, "ftr", device=dev)
    out = {"device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "host", "torch": torch.__version__,
           "b1": traced(ones, params, dev, core, te, spans),
           "bulk": traced(bulk, params, dev, core, te, spans)}
    for key in ("b1", "bulk"):
        r = out[key]
        print(f"B = {r['B']} ({r['calls']} calls): engine reads a call "
              f"{r['engine_reads_a_call']:.1f} (syncs {r['syncs_a_call']:.1f});"
              " by site " + ", ".join(f"{s} {v:.1f}" for s, v in
                                      r["reads_a_call"].items()), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
