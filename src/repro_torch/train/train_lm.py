"""End-to-end example (the counterpart of ``examples/train_lm.py``): train a
causal LM with erasure-coded checkpointing, inject a host failure mid-run,
regenerate the lost checkpoint shard with the paper's FTR planner, restore,
and finish training.

Run:  PYTHONPATH=src python -m repro_torch.train.train_lm [--device cpu]
          [--steps 120] [--preset tiny]

Defaults are CPU-sized (about 1M parameters, 120 steps); ``--preset 100m``
(about 110M parameters) is for the card.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_smoke_config
from . import DataConfig, LoopConfig, OptimizerConfig, train

PRESETS = {
    # about 1.1M parameters: a CPU core
    "tiny": dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
                 num_heads=4, num_kv_heads=4, head_dim=32),
    # about 110M parameters (olmo-style): for the card
    "100m": dict(num_layers=12, d_model=768, d_ff=3072, vocab_size=32768,
                 num_heads=12, num_kv_heads=12, head_dim=64),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-step", type=int, default=70)
    ap.add_argument("--fail-host", type=int, default=3)
    ap.add_argument("--scheme", default="auto",
                    choices=["auto", "star", "fr", "tr", "ftr"])
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              **PRESETS[args.preset])
    res = train(
        cfg,
        DataConfig(batch=args.batch, seq_len=args.seq),
        OptimizerConfig(lr=1e-3),
        LoopConfig(steps=args.steps, ckpt_every=25, log_every=10,
                   blocks_per_host=8),
        fail_at={args.fail_step: args.fail_host},
        scheme=args.scheme, device=args.device,
    )
    print(f"\nran {res.steps_run} steps "
          f"(incl. replay after {len(res.recoveries)} recovery); "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    for rec in res.recoveries:
        d = rec.decision
        print(f"recovery: scheme={d.plan.scheme} predicted={d.predicted_s:.3f}s"
              f" alternatives=" +
              " ".join(f"{k}:{v:.3f}s" for k, v in d.alternatives.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
