"""Checkpoint-shard regeneration walkthrough on a simulated 2-pod fleet (the
counterpart of ``examples/regenerate_checkpoint.py``).

Saves an erasure-coded train-state checkpoint of a yi-6b model over 8
hosts, kills one host, compares the repair plans of STAR / FR / TR / FTR on
the sampled heterogeneous overlay (fast intra-pod, slow cross-pod links,
background traffic), runs the winner on the real GF(2^8) shards, and
checks that the state restores bit for bit.

Run:  PYTHONPATH=src python -m repro_torch.ft.walkthrough [--device cpu] [--full]

The smoke config by default; ``--full`` takes yi-6b at its published
width (6.06e9 bf16 parameters, 12.1 GB of state, 24.2 GB coded), which
needs a card.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..configs import get_config, get_smoke_config
from ..models import init_params
from . import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
from .erasure import tree_flatten


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaNs included)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="yi-6b at full width instead of the smoke config")
    args = ap.parse_args(argv)

    cfg = get_config("yi-6b") if args.full else get_smoke_config("yi-6b")
    model = init_params(cfg, 0, device=args.device)
    state = {"params": model.state_dict(),
             "step": torch.tensor(1000, dtype=torch.int32)}

    fleet = Fleet(FleetConfig(num_pods=2, hosts_per_pod=8,
                              straggler_fraction=0.2), seed=4)
    coder = ErasureCoder(n=8, k=4, d=6, blocks_per_host=16, seed=4,
                         device=model.device)
    # recovery group spans both pods (survives a pod loss of <= n-k hosts)
    hosts = [0, 1, 2, 3, 8, 9, 10, 11]
    ckpt = ECCheckpoint(fleet, coder, hosts, seed=4)
    ckpt.save(state, step=1000)
    nbytes = ckpt.group.block_bytes * coder.M
    print(f"checkpoint of {cfg.name}: {nbytes/1e6:.2f} MB coded as (n=8, k=4, "
          f"d=6) over hosts {hosts} (pods {[fleet.pod_of(h) for h in hosts]})"
          f" on {coder.device}")

    failed = 9
    print(f"\nhost {failed} fails (pod {fleet.pod_of(failed)})")
    log = ckpt.on_host_failure(failed, scheme="auto")
    d = log.decision
    print(f"providers: {d.providers}")
    print("predicted regeneration time per scheme:")
    for name, t in sorted(d.alternatives.items(), key=lambda kv: kv[1]):
        marker = "  <- chosen" if name == d.plan.scheme else ""
        print(f"  {name:5s} {t:8.4f} s{marker}")
    speedup = d.alternatives["star"] / d.predicted_s
    print(f"regeneration {speedup:.2f}x faster than uniform STAR")
    print(f"blocks moved: {log.report.blocks_moved:.0f} "
          f"(full any-k reconstruction would move {coder.M})")

    restored = ckpt.restore([failed, 0, 2, 10])
    want, _ = tree_flatten(state)
    got, _ = tree_flatten(restored)
    if len(got) != len(want) or not all(
            same_bytes(a.to(b.device), b) for a, b in zip(want, got)):
        print("restored state differs", file=sys.stderr)
        return 1
    print("state restored bit-identically from a set containing the "
          "regenerated host: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
