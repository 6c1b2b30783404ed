#!/usr/bin/env python3
"""The routes by which the LM stack's fp32 products of bf16 values can run
on one NVIDIA card, at the shapes phase 7b's olmo-1b step and phase 6b's
yi-6b decode give them (``chip_smoke.py``).

    python3 scripts/product_routes.py [--seed N] [--out F]

First what the installed torch offers: whether ``torch.mm`` and
``torch.bmm`` with ``out_dtype=torch.float32`` (``aten::mm.dtype``) run on
bf16 operands on the card, whether autograd has a derivative for them and
whether DTensor has a sharding strategy for them.  Then, at each shape,
the device ms (CUDA events, mean of warm runs) of: the operands upcast
and multiplied in fp32 with IEEE products (the port's plain version), the
same with TF32 allowed (the upcast timed apart), bf16 operands with
``out_dtype=torch.float32``, and the plain bf16 product (bf16 out) as a
yardstick; and each route's largest difference from the IEEE product over
the product's largest |value|.  Prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (label, batch or None, M, K, N): olmo-1b at 2 x 2,048 tokens a microbatch
# (H = 16, D = 128, q_chunk 1,024, kv_chunk 2,048, V = 50,304), and yi-6b's
# decode logits at B = 4 (d = 4,096, V = 64,000)
SHAPES = [("attention scores", 32, 1024, 128, 2048),
          ("attention values", 32, 1024, 2048, 128),
          ("loss logits", None, 4096, 2048, 50304),
          ("loss dW", None, 2048, 4096, 50304),
          ("decode logits_last", None, 4, 4096, 64000)]


def offers() -> dict:
    from torch.distributed.tensor import DTensor

    a = torch.randn(8, 16, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    b = torch.randn(16, 4, device="cuda", dtype=torch.bfloat16)
    out = {}
    try:
        c = torch.mm(a, b, out_dtype=torch.float32)
        out["mm_out_dtype"] = str(c.dtype)
        try:
            c.sum().backward()
            out["mm_out_dtype_backward"] = "ok"
        except RuntimeError as e:
            out["mm_out_dtype_backward"] = str(e)[:200]
    except (RuntimeError, NotImplementedError, TypeError) as e:
        out["mm_out_dtype"] = f"{type(e).__name__}: {str(e)[:200]}"
    try:
        c = torch.bmm(a[None].detach(), b[None], out_dtype=torch.float32)
        out["bmm_out_dtype"] = str(c.dtype)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        out["bmm_out_dtype"] = f"{type(e).__name__}: {str(e)[:200]}"
    strategies = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    out["dtensor_strategy"] = {str(op): op in strategies for op in (
        torch.ops.aten.mm.dtype, torch.ops.aten.bmm.dtype)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("product_routes: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    rec = dict(card=card, torch=torch.__version__, offers=offers(), shapes=[])
    print(json.dumps(rec["offers"]), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flags = torch.backends.cuda.matmul
    for label, batch, m, k, n in SHAPES:
        lead = () if batch is None else (batch,)
        a = torch.randn(lead + (m, k), device="cuda", generator=gen
                        ).bfloat16()
        b = torch.randn(lead + (k, n), device="cuda", generator=gen
                        ).bfloat16()
        mm = torch.mm if batch is None else torch.bmm
        af, bf = a.float(), b.float()
        want = mm(af, bf)
        scale = float(want.abs().max())
        row = dict(shape=label, batch=batch, m=m, k=k, n=n,
                   flops=2 * (batch or 1) * m * k * n)
        row["upcast_ms"] = cuda_ms(lambda: (a.float(), b.float()), 20)
        row["fp32_ieee_ms"] = cuda_ms(lambda: mm(af, bf), 20)
        flags.allow_tf32 = True
        try:
            row["tf32_ms"] = cuda_ms(lambda: mm(af, bf), 20)
            row["tf32_err"] = float((mm(af, bf) - want).abs().max()) / scale
        finally:
            flags.allow_tf32 = False
        try:
            row["bf16_out_fp32_ms"] = cuda_ms(
                lambda: mm(a, b, out_dtype=torch.float32), 20)
            row["bf16_out_fp32_err"] = float(
                (mm(a, b, out_dtype=torch.float32) - want).abs().max()) / scale
        except (RuntimeError, NotImplementedError, TypeError) as e:
            row["bf16_out_fp32_ms"] = f"{type(e).__name__}: {str(e)[:120]}"
        row["bf16_ms"] = cuda_ms(lambda: mm(a, b), 20)
        rec["shapes"].append(row)
        print(json.dumps(row), flush=True)
        del a, b, af, bf, want
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
