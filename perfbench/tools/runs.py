#!/usr/bin/env python3
"""Run one cell several times, one process a run, one run at a time, and
keep every result line.

    python3 perfbench/tools/runs.py --workload <cell> --seeds 11 12 13 \
        --seconds 30 [--trace 0|1] [--out <file>.jsonl]

Prints the card's name, power limit and the versions first, then one line
a run: its wall seconds, ``correct``, the metrics and the checks.  The
result lines and the end of each run's standard error go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    out = open(args.out, "a") if args.out else None
    bad = 0
    for seed in args.seeds:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "perfbench" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.time() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        if res is None or proc.returncode != 0 or not res["correct"]:
            bad += 1
        summary = {"seed": seed, "rc": proc.returncode, "wall_s": wall}
        if res is not None:
            summary.update(correct=res["correct"],
                           attempted=res["attempted"], failed=res["failed"],
                           metrics={k: v["value"]
                                    for k, v in res["metrics"].items()},
                           peak_gib=res["device"]["memory_peak_bytes"] / 2**30,
                           checks={k: v["value"]
                                   for k, v in res["checks"].items()})
            if "busy_s" in res["device"]:
                summary.update(busy_s=res["device"]["busy_s"],
                               window_s=res["device"]["window_s"])
        print(json.dumps(summary), flush=True)
        if res is None or proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
        if out:
            out.write(json.dumps({"seed": seed, "rc": proc.returncode,
                                  "wall_s": wall, "result": res,
                                  "stderr_tail": proc.stderr[-4000:]}) + "\n")
            out.flush()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
