#!/usr/bin/env python3
"""Where the GF(2^8) matmul kernel's time goes, on one NVIDIA card.

    python3 scripts/gf_matmul_variants.py [--out results.json] [--reps 3]

Builds the kernel (``src/repro_torch/kernels/csrc/gf_matmul.cu``) and
edited copies of it, each with one part of the per-step work taken out,
and times all of them in turns (forward, then backward) at the main path's
4 MiB-wide shapes and at the checkpoint's odd width (N = 189,407,361, the
shifted variant) beside the same M and K at N rounded down to a multiple of
8 (the same storage; the aligned variant).  A copy that takes work out
computes wrong bytes, so only the unchanged kernel and ``ahead8`` are
checked against the plain version.  The copies:

* ``no_spread``: the fragment registers are constants; the payload is still
  loaded but not spread into bits.
* ``no_loads``: no payload load is started or waited for; the spreads read
  whatever the ring holds.
* ``no_stores``: the epilogue packs the output bytes but neither stores
  them nor stages them (the shifted variant's named barriers stay).
* ``wgmma_only``: all three; what is left is the band's staging, the
  wgmmas with their fences and waits, and the per-tile drain.
* ``one_word``: the shifted variant copies only the first of its two
  aligned words a step (the cost of the second copy).
* ``ahead8``: the shifted variant with 8 payload steps in flight instead of
  16 (a 32 KiB ring, so 368 rows of T at once); right bytes, another speed.
* ``forced_shifted``: the unchanged kernel with every launch sent to the
  shifted variant, so at N % 8 == 0 it reads rows that start 64-byte
  aligned: its instructions without the odd width's misaligned rows.

Prints the card and one line per copy; the last line is a JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = 4 << 20
ODD = 189_407_361                 # yi-6b's checkpoint block (phase 6a)
EVEN = ODD - ODD % 8
SHAPES = [(960, 240, W), (240, 240, W), (48, 94, W), (8, 48, W), (11, 48, W),
          (64, 64, ODD), (64, 64, EVEN), (6, 16, ODD), (6, 16, EVEN)]
NO_SPREAD = [("a[q][x] = spread_nibble(nibs[x], q);",
              "a[q][x] = (x + q + s0) * 0x01010101u;")]
NO_LOADS = [("          cp_async_wait<V::kAhead - 1>();\n", ""),
            ("          fetch_step<kVariant>(cur, ring, slot, B, K, N, n_tiles, "
             "steps, col_in_tile, krow,\n                               sh, u & 1);\n",
             "")]
NO_STORES = [("      if ((c >> 1) == t) {",
              "      if ((c >> 1) == t && o1 == 0x12345678u) {"),
             ("      if (col0 < N) store_staged(rows_out, stage, N, col0, warp, lane, "
              "threadIdx.x & 127);", "")]
ONE_WORD = [("    cp_async8(dst + 8, c.p + 8, n1);\n", "")]
AHEAD8 = [("constexpr int kShiftedAhead = 16;", "constexpr int kShiftedAhead = 8;"),
          ("constexpr int kShiftedChunkRows = 304;",
           "constexpr int kShiftedChunkRows = 368;")]
COPIES = {"kernel": [], "no_spread": NO_SPREAD, "no_loads": NO_LOADS,
          "no_stores": NO_STORES,
          "wgmma_only": NO_SPREAD + NO_LOADS + NO_STORES, "one_word": ONE_WORD,
          "ahead8": AHEAD8, "forced_shifted": []}
CHECKED = ("kernel", "ahead8", "forced_shifted")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_matmul_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    km = importlib.import_module("repro_torch.kernels.gf_matmul")
    from repro_torch.kernels import gf_matmul_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    source = km.SOURCE.read_text()
    variants = km.VARIANTS
    operands_aligned = km.operands_aligned
    out_dir = km.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in COPIES.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"gf_matmul_{name}.cu"
        paths[name].write_text(text)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    data = {}
    for s in SHAPES:
        a = torch.randint(0, 256, s[:2], dtype=torch.uint8, device="cuda",
                          generator=gen)
        if s[2] == EVEN:        # N rounded down, on the odd shape's storage
            b = data[(s[0], s[1], ODD)][1].view(-1)[:s[1] * EVEN].view(s[1], EVEN)
        else:
            b = torch.randint(0, 256, s[1:], dtype=torch.uint8, device="cuda",
                              generator=gen)
        data[s] = (a, b)

    def use(name):
        km.SOURCE = paths[name]
        shifted = variants[km.SHIFTED]
        if name == "ahead8":
            shifted = dataclasses.replace(shifted, ahead=8, chunk_rows=368)
        km.VARIANTS = (variants[km.ALIGNED], shifted)
        km.operands_aligned = (lambda b, c: False) if name == "forced_shifted" \
            else operands_aligned
        km.launch_plan.cache_clear()
        km.library.cache_clear()
        km.device_sms.cache_clear()
        for line in km.build()[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)
        km.device_sms(torch.device("cuda", torch.cuda.current_device()))

    times = {name: {s: [] for s in SHAPES} for name in COPIES}
    order = list(COPIES) + list(reversed(COPIES))
    for name in order:
        use(name)
        if name in CHECKED:
            for s in [(5, 3, 17), (240, 240, 1 << 20), (64, 64, 1_000_001),
                      (9, 1024, 100_003)]:
                a = torch.randint(0, 256, s[:2], dtype=torch.uint8,
                                  device="cuda", generator=gen)
                b = torch.randint(0, 256, s[1:], dtype=torch.uint8,
                                  device="cuda", generator=gen)
                if not torch.equal(km.gf_matmul_cuda(a, b), gf_matmul_ref(a, b)):
                    raise AssertionError(f"{name} != plain at {s}")
        for s in SHAPES:
            a, b = data[s]
            km.gf_matmul_cuda(a, b)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                km.gf_matmul_cuda(a, b)
            end.record()
            torch.cuda.synchronize()
            times[name][s].append(start.elapsed_time(end) / args.reps)
    rows = {name: {"x".join(map(str, s)): sum(v) / len(v)
                   for s, v in per.items()} for name, per in times.items()}
    for name, per in rows.items():
        print(name, " ".join(f"{k}={v}" for k, v in per.items()), flush=True)
    result = {"card": card, "ms": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
