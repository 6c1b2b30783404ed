"""Batched serving demo (the counterpart of ``examples/serve_lm.py``):
prefill and lock-step decode on the serving engine.

Run:  PYTHONPATH=src python -m repro_torch.serve.serve_lm [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..configs import get_smoke_config
from ..models import init_params
from . import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_smoke_config("qwen2.5-14b"),  # GQA-style smoke config
        num_layers=2, d_model=128, d_ff=256, vocab_size=512,
        num_heads=8, num_kv_heads=2, head_dim=16)
    model = init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, model, slots=4, max_len=96, seed=1,
                      device=model.device)

    reqs = [Request(prompt=[(7 * i + j) % cfg.vocab_size for j in range(4 + i)],
                    max_new_tokens=12, temperature=0.0 if i % 2 else 0.8,
                    rid=i)
            for i in range(10)]
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(o.tokens) for o in outs)
    print(f"served {len(reqs)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s on {eng.device})")
    for o in outs:
        print(f"  rid={o.rid}: {o.tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
