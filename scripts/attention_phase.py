#!/usr/bin/env python3
"""The fused attention kernel alone on one NVIDIA card
(``chip_smoke.attention_phase``): its build and ptxas report, its output
and gradients against ``chunked_attention`` at olmo-1b's microbatch, and
its forward and backward times beside the bound, the plain version and
``scaled_dot_product_attention``.

    python3 scripts/attention_phase.py [--seed N] [--out results.json]

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
        print("attention_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    rec = cs.attention_phase(args.seed)
    rec["card"] = card
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
