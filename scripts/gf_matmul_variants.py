#!/usr/bin/env python3
"""Where the GF(2^8) matmul kernel's time goes, on one NVIDIA card.

    python3 scripts/gf_matmul_variants.py [--out results.json]

Builds the kernel (``src/repro_torch/kernels/csrc/gf_matmul.cu``) and
edited copies of it, each with one part of the per-step work taken out,
and times all of them in turns (forward, then backward) at the main path's
4 MiB-wide shapes.  A copy computes wrong bytes, so only the unchanged
kernel is checked against the plain version.  The copies:

* ``no_spread``: the fragment registers are constants; the payload is still
  loaded but not spread into bits.
* ``no_loads``: no payload load is started or waited for; the spreads read
  whatever the ring holds.
* ``no_stores``: the epilogue packs the output bytes but does not store them.
* ``wgmma_only``: all three; what is left is the band's staging, the
  wgmmas with their fences and waits, and the per-tile drain.

Prints the card and one line per variant; the last line is a JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = 4 << 20
SHAPES = [(960, 240, W), (240, 240, W), (48, 94, W), (8, 48, W), (11, 48, W)]
NO_SPREAD = [("a[q][x] = spread_nibble(nibs[x], q);",
              "a[q][x] = (x + q + s0) * 0x01010101u;")]
NO_LOADS = [("          cp_async_wait<kAhead - 1>();\n", ""),
            ("          fetch_step<kVec>(cur, ring, slot, B, K, N, n_tiles, "
             "steps, col_in_tile, krow);\n", "")]
NO_STORES = [("if ((c >> 1) == t && m < M) {",
              "if ((c >> 1) == t && m < M && o1 == 0x12345678u) {")]
VARIANTS = {"kernel": [], "no_spread": NO_SPREAD, "no_loads": NO_LOADS,
            "no_stores": NO_STORES,
            "wgmma_only": NO_SPREAD + NO_LOADS + NO_STORES}


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
    out_dir = km.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"gf_matmul_{name}.cu"
        paths[name].write_text(text)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    data = {s: (torch.randint(0, 256, s[:2], dtype=torch.uint8, device="cuda",
                              generator=gen),
                torch.randint(0, 256, s[1:], dtype=torch.uint8, device="cuda",
                              generator=gen)) for s in SHAPES}

    def use(name):
        km.SOURCE = paths[name]
        km.library.cache_clear()
        km.device_sms.cache_clear()
        km.device_sms(torch.device("cuda", torch.cuda.current_device()))

    times = {name: {s: [] for s in SHAPES} for name in VARIANTS}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for name in order:
        use(name)
        if name == "kernel":
            for s in [(5, 3, 17), (240, 240, 1 << 20)]:
                a = data[SHAPES[1]][0][:s[0], :s[1]].contiguous()
                b = data[SHAPES[1]][1][:s[1], :s[2]].contiguous()
                if not torch.equal(km.gf_matmul_cuda(a, b), gf_matmul_ref(a, b)):
                    raise AssertionError(f"kernel != plain at {s}")
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
