#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` alone, on one NVIDIA card: olmo-1b's train
step sharded on a 1x1 mesh against the plain step, and the dry run's cells
on the host.

    python3 scripts/shard_phase.py [--seed N] [--out results.json]

Runs ``chip_smoke.shard_phase``: 3 steps of 4 x 2048 tokens in 2
microbatches, plain, with ``grad_shardings`` and with
``gather_weights_once``, held to each other within rtol 1e-5 (step times
and peak memory recorded), while ``python -m repro_torch.launch.dryrun``
runs ``chip_smoke.DRYRUN_CELLS`` on the host, each cell checked.  Every
check of the phase applies.  Prints the card and the phase's lines; the
last line is a JSON object with the record.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    rec = cs.shard_phase(args.seed, ROOT)
    rec["seconds"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
