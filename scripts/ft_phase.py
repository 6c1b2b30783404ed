#!/usr/bin/env python3
"""Phase 6 of ``chip_smoke.py`` alone, on one NVIDIA card: checkpoint
regeneration and the LM stack at yi-6b's full width.

    python3 scripts/ft_phase.py [--seed N] [--out results.json]

Builds the GF(2^8) kernel, draws yi-6b (bf16) on the card, and runs
``chip_smoke.ft_phase`` (save as an n=8 k=4 d=6 checkpoint, five
regenerations of one host with star/fr/tr/ftr/auto, ten bit-exact restores,
the kernel against the plain version on column windows at every product
shape) and ``chip_smoke.lm_phase`` (prefill of 2,048 tokens, 16
teacher-forced decode steps held to the parallel forward, one layer's
chunked attention held to dense fp32 attention).  Every check of the phase
applies; the quicker way to try a change to the phase than the whole smoke
run.  Prints the card and the phase's lines; the last line is a JSON
object with the records.
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
        print("ft_phase: CUDA is not available", file=sys.stderr)
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
    cfg = get_config(cs.FT_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    print(f"init_params: {time.perf_counter() - t0:.2f} s", flush=True)
    record, kernel = cs.ft_phase(args.seed, cfg, model)
    out = dict(checkpoint=record, lm=cs.lm_phase(args.seed, cfg, model),
               kernel=kernel, seconds=time.perf_counter() - t0)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
