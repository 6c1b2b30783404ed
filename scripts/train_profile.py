#!/usr/bin/env python3
"""Where one eager training step of olmo-1b goes on one NVIDIA card, at
phase 7b's shapes (``chip_smoke.py``): device ms by category, kernels and
the device's idle share.

    python3 scripts/train_profile.py [--tree SRC] [--seed N] [--steps N]
                                     [--out F]

``--tree`` is the ``src`` directory of the port to import (default this
checkout's), so a parent commit unpacked with ``git archive`` is profiled
by the same code.  Builds olmo-1b (bf16, random weights from ``--seed``),
AdamW with fp32 moments, and batches of 4 x 2,048 tokens in 2 microbatches;
runs ``--steps`` eager steps through ``make_train_step``, each timed by the
host clock to a synchronize, then profiles one more with
``chip_smoke.step_profile`` (the categories are listed there; the idle
share that counts is the device's busy time against the unprofiled step,
since the profiler slows the host).  Prints the card, the steps, the
profile's summary and, last, one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT / "src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(args.tree.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import (DataConfig, OptimizerConfig, SyntheticLM,
                                   init_opt, make_train_step)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.TRAIN_ARCH)
    opt_cfg = OptimizerConfig()
    model = init_params(cfg, args.seed, device=dev)
    opt = init_opt(opt_cfg, model, device=dev)
    data = SyntheticLM(DataConfig(seed=args.seed, **cs.TRAIN_DATA), cfg,
                       device=dev)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=cs.TRAIN_LOOP["n_micro"])
    step_ms, losses = [], []
    for step in range(args.steps):
        batch = data.batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        print(f"step {step}: {step_ms[-1]:.1f} ms, loss {losses[-1]:.6f}",
              flush=True)
    batch = data.batch_at(args.steps)
    prof = cs.step_profile(lambda: step_fn(model, opt, batch))
    warm = step_ms[1:] or step_ms
    prof["idle_share_of_step"] = (1 - prof["device_busy_ms"]
                                  / statistics.median(warm))
    print(cs.profile_line("eager step", prof), flush=True)
    del prof["order"]
    tokens = cs.TRAIN_DATA["batch"] * cs.TRAIN_DATA["seq_len"]
    out = dict(card=card, torch=torch.__version__, tree=str(args.tree),
               arch=cfg.name, data=cs.TRAIN_DATA,
               n_micro=cs.TRAIN_LOOP["n_micro"], step_ms=step_ms,
               losses=losses, tokens_per_s=tokens * 1e3 /
               statistics.median(warm),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               profile=prof)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
