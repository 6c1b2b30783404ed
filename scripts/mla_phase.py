#!/usr/bin/env python3
"""Phase 7d of ``chip_smoke.py`` alone, on one NVIDIA card
(``chip_smoke.mla_phase``): the fused attention's (192, 128) variant, its
build and ptxas report, its gates against ``chunked_attention`` at
DeepSeek-V2-Lite's microbatch, its time a call over its bound beside the
D = 128 variant's, and a profiled eager step of the benchmark's
DeepSeek-V2-Lite share with its launch counts.

    python3 scripts/mla_phase.py [--seed N] [--out results.json]

Prints the card and the phase's lines; the last line is a JSON object with
the kernel's record.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mla_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    rec = cs.mla_phase(args.seed, ROOT)
    rec["card"] = card
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
