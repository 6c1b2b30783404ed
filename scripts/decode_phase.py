#!/usr/bin/env python3
"""Phases 6b, 7a and 6b' of ``chip_smoke.py`` alone, on one NVIDIA card:
the LM's decode step eager and as a captured CUDA graph, and the serving
engine that replays it.

    python3 scripts/decode_phase.py [--seed N] [--out results.json]

Draws yi-6b (bf16) on the card and runs ``chip_smoke.lm_phase`` (prefill
of 2,048 tokens; 16 teacher-forced steps through eager ``decode_step`` and
a ``DecodeGraph`` in turns, the graph's logits held to eager's and both
to the parallel forward) and ``chip_smoke.serve_phase`` (the engine, 4
slots, every decode step a replay); then frees it and runs
``chip_smoke.graph_phase`` (the same eager-against-graph check and gates
at olmoe-1b-7b and zamba2-7b, B = 4, then at every causal smoke config).  Every check of those phases applies;
builds no kernel.  Prints the card and the phases' lines; the last line
is a JSON object with the records.
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
        print("decode_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = get_config(cs.FT_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    print(f"init_params: {time.perf_counter() - t0:.2f} s", flush=True)
    out = dict(card=card, lm=cs.lm_phase(args.seed, cfg, model),
               serve=cs.serve_phase(args.seed, cfg, model))
    del model
    out["lm_graphs"] = cs.graph_phase(args.seed)
    out["seconds"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
