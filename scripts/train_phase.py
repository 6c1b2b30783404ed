#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` alone, on one NVIDIA card: serving yi-6b
and training olmo-1b with a host failure, both at full width.

    python3 scripts/train_phase.py [--seed N] [--out results.json]

Builds the GF(2^8) kernel, draws yi-6b (bf16) on the card, and runs
``chip_smoke.serve_phase`` (6 requests over 4 slots, greedy tokens held to
the parallel forward, seeded sampling repeated) and then
``chip_smoke.train_phase`` (olmo-1b, 8 steps of 4 x 2048 tokens with an
erasure-coded checkpoint every 4, once uninterrupted and once with host 3
failing after step 5: FTR regeneration through the kernel, a byte-exact
restore, the replayed losses held to the uninterrupted run's; the kernel
against the plain version on column windows at every product shape).
Every check of the phase applies; the quicker way to try a change to the
phase than the whole smoke run.  Prints the card and the phase's lines; the
last line is a JSON object with the records.
"""
from __future__ import annotations

import argparse
import importlib
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
        print("train_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kmod = importlib.import_module("repro_torch.kernels.gf_matmul")
    kmod.build()
    kmod.device_sms(torch.device("cuda", torch.cuda.current_device()))
    t0 = time.perf_counter()
    cfg = get_config(cs.FT_ARCH)
    model = init_params(cfg, args.seed, device="cuda")
    serve = cs.serve_phase(args.seed, cfg, model)
    del model
    train, kernel = cs.train_phase(args.seed)
    out = dict(serve=serve, train=train, kernel=kernel,
               seconds=time.perf_counter() - t0)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
