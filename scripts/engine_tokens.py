#!/usr/bin/env python3
"""The serving engine's completions on the CPU at every token-frontend
smoke config, to compare two trees of the port (for example a parent
commit unpacked with ``git archive`` and this one).

    PYTHONPATH=<tree>/src python3 scripts/engine_tokens.py --out A.json
    python3 scripts/engine_tokens.py --compare A.json B.json

Each config in fp32 and in bf16, random weights, 7 requests (prompts of 2
to 11 tokens, 3 to 8 new tokens, temperatures 0, 0.7, 0, 1.3 in turn),
served on 4 slots and on 3 (so the last chunk is short); ``--compare``
prints how many of the cases give the same tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def completions() -> dict:
    import torch
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    torch.set_num_threads(1)
    out = {}
    for arch in ARCH_IDS:
        base = get_smoke_config(arch)
        if not base.causal or base.frontend != "tokens":
            continue
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, param_dtype=dtype,
                                      compute_dtype=dtype)
            model = init_params(cfg, 4, device="cpu")
            rng = np.random.default_rng(9)
            reqs = [Request(prompt=rng.integers(
                        1, cfg.vocab_size, int(rng.integers(2, 12))).tolist(),
                        max_new_tokens=int(rng.integers(3, 9)),
                        temperature=[0.0, 0.7, 0.0, 1.3][i % 4], rid=i)
                    for i in range(7)]
            for slots in (4, 3):
                eng = ServeEngine(cfg, model, slots=slots, max_len=32,
                                  seed=11, device="cpu")
                out[f"{arch}/{dtype}/{slots}"] = [
                    c.tokens for c in eng.generate(reqs)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        same = [k for k in a if a[k] == b.get(k)]
        print(f"{len(same)} of {len(a)} cases give the same tokens; "
              f"different: {sorted(set(a) - set(same))}")
        return 0 if len(same) == len(a) == len(b) else 1
    res = completions()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(len(res), "cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
