#!/usr/bin/env python3
"""How far the decode step's logits drift from the parallel forward's with
depth and dtype, on the CPU: zamba2-7b's layout (ssm layers with a shared
attention block every 6, the SSD chunk of 256) at narrow widths.

    python3 scripts/decode_drift.py [--layers 12 81] [--seed N]

For each depth, in fp32 and in bf16: B = 4 prompts of 128 tokens
prefilled, 16 teacher-forced decode steps, and the forward over all 144
tokens; prints the largest |logit| and, per position from the prompt's
last on, the largest difference over the largest |logit|.  In fp32 the
step is the forward's; in bf16 the step's rounding departs from the
chunked scan's, more with depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step, embed_inputs,  # noqa: E402
                                forward_hidden, init_cache, init_params,
                                prefill)

B, S, T = 4, 128, 16


@torch.no_grad()
def drift(layers: int, dtype: str, seed: int) -> tuple:
    cfg = dataclasses.replace(
        get_smoke_config("zamba2-7b"), num_layers=layers, shared_attn_every=6,
        ssm_chunk=256, d_model=256, d_ff=512, num_heads=8, num_kv_heads=8,
        head_dim=32, ssm_state=64, ssm_head_dim=64, q_chunk=512,
        kv_chunk=1024, vocab_size=512, param_dtype=dtype, compute_dtype=dtype)
    model = init_params(cfg, seed, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S + T),
                         generator=torch.Generator().manual_seed(seed + 8))
    cache = init_cache(cfg, B, S + T, dtype=getattr(torch, dtype),
                       device="cpu")
    first, _ = prefill(cfg, model, {"tokens": toks[:, :S]}, cache)
    steps = [decode_step(cfg, model, cache, toks[:, S + i:S + i + 1],
                         S + i)[0] for i in range(T)]
    got = torch.stack([first] + steps, dim=1)
    h = embed_inputs(cfg, model, {"tokens": toks})
    h, _ = forward_hidden(cfg, model, h, positions=torch.arange(
        S + T, dtype=torch.int32))
    h = model.final_norm(h)
    want = h[:, S - 1:].float() @ model.embed.table().float().t()
    scale = float(want.abs().max())
    return scale, ((got - want).abs().amax(dim=(0, 2)) / scale).tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 81])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for layers in args.layers:
        for dtype in ("float32", "bfloat16"):
            scale, rel = drift(layers, dtype, args.seed)
            print(f"{layers} layers {dtype}: largest |logit| {scale:.3f}; "
                  f"difference / largest by position: "
                  + " ".join(f"{r:.2e}" for r in rel), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
