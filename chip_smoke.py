#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

What it does, in order; any failed check raises and the exit code is
nonzero:

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the GF(2^8) matmul kernel (bit-matrix
   ``wgmma``) from ``src/repro_torch/kernels/csrc/gf_matmul.cu`` for sm_90a
   and prints ptxas's registers and spills.
2. The main path, at the paper's Fig. 7 deployment (arXiv:1603.05163 §VI:
   MSR n=20, k=5, d=10) with the file cut into M = 240 blocks of 4 MiB
   (960 MiB; alpha = 48, beta = 8): the file is distributed onto 20 nodes
   on the card, then one node is failed and repaired with each of star,
   fr, tr and ftr in turn.  Each repair samples a U[10,120] overlay, plans
   it on the host and runs the plan through the kernel; the file is then
   decoded from the newcomer plus k-1 other nodes and must equal the
   original bit for bit; the same repair re-run from the same random
   state with the plain PyTorch matmul on the card must give the same
   newcomer; and 64 sampled k-subsets must reconstruct.  The kernel's
   launch counter is zeroed before this phase and must have risen after.
3. The kernel against its plain version on the card (``torch.equal``):
   mapping probes (the identity with single-bit payloads at K = 1..5 and
   1024, single set bits in a zero payload, N = 1000 and the byte-wise
   N = 1001, a payload 4 bytes off alignment), ragged shapes, zeros, the
   identity and every product shape the main path ran; the plain
   bit-matrix version against the plain version.  Then times of both at
   each main-path shape beside the card's bound for that work, and at the
   distribute and decode shapes ``torch._int_mm`` (cuBLASLt) on the
   kernel's own bit-matrix product as a yardstick (``int8_gemm_ms``).  The
   kernel's ``ms`` in the record is the main path's own launches, timed by
   CUDA events around each call.

The next-to-last line is the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits nonzero and prints
no result.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_MACS_PER_S = 1979e12 / 2      # H100 SXM dense int8 tensor cores
PARAMS = dict(n=20, k=5, d=10, M=240.0)
BLOCK_BYTES = 4 * MIB
SCHEMES = ("star", "fr", "tr", "ftr")
PROB_SAMPLES = 64
INT8_CHUNK = 1 << 16             # payload columns per torch._int_mm call


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_terms(m: int, k: int, n: int):
    """(bytes ms, operations ms) of one (M, K, N) GF(2^8) product on the
    card: each operand read once and the output written once over HBM, and
    64 bit-plane int8 MACs per field product over the tensor cores.  The
    bound is the larger of the two."""
    return ((m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3,
            64 * m * k * n / INT8_MACS_PER_S * 1e3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int8_gemm_ms(a: torch.Tensor, n: int, gen) -> float:
    """Device ms of ``torch._int_mm`` (cuBLASLt) on the kernel's own
    bit-matrix product for A (M, K) and an (K, n) payload: B_bits^T
    (INT8_CHUNK x 8K) int8 times T^T (8K x 8M) int8, timed on one column
    chunk and scaled by n / INT8_CHUNK.  The packed parity of its counts
    must equal the kernel's product on that chunk."""
    from repro_torch.kernels import gf_bitmatrix, gf_matmul_cuda

    m, kk = a.shape
    t_t = gf_bitmatrix(a).to(torch.int8).t()              # (8K, 8M)
    bc = rand_u8((kk, INT8_CHUNK), gen)
    shifts = torch.arange(8, device=DEVICE, dtype=torch.int32)
    bbits = ((bc.to(torch.int32).unsqueeze(1) >> shifts.view(1, 8, 1)) & 1) \
        .reshape(8 * kk, INT8_CHUNK).t().contiguous().to(torch.int8)
    ms = cuda_ms(lambda: torch._int_mm(bbits, t_t), 3) * n / INT8_CHUNK
    bits = (torch._int_mm(bbits, t_t) & 1).view(INT8_CHUNK, m, 8)
    packed = (bits << shifts).sum(dim=-1).to(torch.uint8).t()
    if not torch.equal(packed, gf_matmul_cuda(a, bc)):
        raise AssertionError(f"int8 GEMM parity != kernel at M={m}, K={kk}")
    return ms


class ShapeLog:
    """A GF matmul that records the (M, K, N) of every call, brackets the
    call with CUDA events on the current stream, and passes it on unchanged
    (here: to the port's dispatcher, i.e. the kernel)."""

    def __init__(self, matmul):
        self.matmul = matmul
        self.shapes = collections.Counter()
        self.events = []          # [((M, K, N), start, end), ...]

    def __call__(self, a, b):
        shape = (a.shape[0], a.shape[1], b.shape[1])
        self.shapes[shape] += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.matmul(a, b)
        end.record()
        self.events.append((shape, start, end))
        return out

    def ms_by_shape(self):
        """Device ms between each call's events, summed per shape (call
        after a synchronize)."""
        total = collections.Counter()
        for shape, start, end in self.events:
            total[shape] += start.elapsed_time(end)
        return total


def rand_u8(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE,
                         generator=gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the full results here as JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import importlib

    from repro_torch.core import CodeParams
    from repro_torch.kernels import (gf_matmul, gf_matmul_bitmatrix,
                                     gf_matmul_cuda, gf_matmul_ref)
    from repro_torch.storage import RlncSimulator, uniform
    kmod = importlib.import_module("repro_torch.kernels.gf_matmul")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    results = {"card": card, "seed": args.seed}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, build_out = kmod.build()
    kmod.device_sms(torch.device(DEVICE, torch.cuda.current_device()))
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.2f} s -> {lib_path.name}")
    for line in build_out.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "serialized")):
            log("  ptxas:", line.strip())

    # -- 2. main path: distribute, then one repair per scheme ---------------
    params = CodeParams.msr(**PARAMS)
    M, alpha, k = int(params.M), int(round(params.alpha)), params.k
    shape_log = ShapeLog(gf_matmul)
    gf_matmul_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = RlncSimulator(params, block_bytes=BLOCK_BYTES, seed=args.seed,
                        matmul=shape_log)
    torch.cuda.synchronize()
    results["setup_s"] = time.perf_counter() - t0
    file_blocks = sim.file_blocks
    if not (file_blocks.is_cuda and file_blocks.shape == (M, BLOCK_BYTES)
            and all(nd.payload.shape == (alpha, BLOCK_BYTES)
                    and nd.payload.device == file_blocks.device
                    for nd in sim.nodes.values())):
        raise AssertionError("distribute left the store malformed")
    log(f"distribute: {params.n} nodes x {alpha} x {BLOCK_BYTES} B on "
        f"{sim.device}, file {file_blocks.numel() / MIB:.0f} MiB, "
        f"{results['setup_s']:.2f} s with the host draws")

    repairs = []
    for scheme in SCHEMES:
        before = (dict(sim.nodes), sim.np_rng.bit_generator.state,
                  sim.rng.getstate())
        launched = gf_matmul_cuda.launches
        t0 = time.perf_counter()
        [(failed, providers, plan)] = sim.plan_rounds(scheme, uniform(), 1)
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim.execute_plan(plan, failed, providers)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t0
        launched = gf_matmul_cuda.launches - launched
        if launched <= 0:
            raise AssertionError(f"{scheme}: the repair launched no kernel")
        newcomer = sim.nodes[failed]
        if newcomer.payload.shape != (alpha, BLOCK_BYTES):
            raise AssertionError(f"{scheme}: newcomer holds "
                                 f"{tuple(newcomer.payload.shape)}")

        others = [i for i in sorted(sim.nodes) if i != failed][:k - 1]
        t0 = time.perf_counter()
        decoded = sim.rl.reconstruct(
            [newcomer] + [sim.nodes[i] for i in others], M)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if not torch.equal(decoded, file_blocks):
            raise AssertionError(f"{scheme}: decoded file differs")
        del decoded

        # the same repair from the same state, with the plain matmul
        np_rng = np.random.default_rng()
        np_rng.bit_generator.state = before[1]
        py_rng = random.Random()
        py_rng.setstate(before[2])
        plain = RlncSimulator.from_state(params, file_blocks, before[0],
                                         np_rng, py_rng, matmul=gf_matmul_ref)
        [(f2, p2, plan2)] = plain.plan_rounds(scheme, uniform(), 1)
        if (f2, p2, plan2.parent) != (failed, providers, plan.parent):
            raise AssertionError(f"{scheme}: the rerun drew another repair")
        plain.execute_plan(plan2, f2, p2)
        if not (torch.equal(plain.nodes[f2].vectors, newcomer.vectors)
                and torch.equal(plain.nodes[f2].payload, newcomer.payload)):
            raise AssertionError(f"{scheme}: kernel and plain repairs differ")
        del plain

        t0 = time.perf_counter()
        prob = sim.reconstruction_probability(samples=PROB_SAMPLES)
        t_prob = time.perf_counter() - t0
        if not 0.9 <= prob <= 1.0:
            raise AssertionError(f"{scheme}: reconstruction probability {prob}")
        rep = dict(scheme=scheme, failed=failed, plan_time=plan.time,
                   traffic=plan.total_traffic, plan_s=t_plan, execute_s=t_exec,
                   decode_s=t_dec, probability=prob, probability_s=t_prob,
                   repair_launches=launched)
        repairs.append(rep)
        log(f"repair {scheme}: node {failed}, planned time "
            f"{plan.time:.4f} (blocks over link rates), traffic "
            f"{plan.total_traffic:.2f} blocks; "
            f"plan {t_plan:.3f} s, execute {t_exec:.3f} s ({launched} "
            f"launches), decode {t_dec:.3f} s (bitwise), plain rerun equal, "
            f"P(reconstruct) {prob:.4f} over {PROB_SAMPLES} subsets")
    launches = gf_matmul_cuda.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    torch.cuda.synchronize()
    main_ms = shape_log.ms_by_shape()
    results.update(repairs=repairs, main_path_launches=launches,
                   main_path_kernel_ms=sum(main_ms.values()),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"main path: {launches} kernel launches, "
        f"{sum(shape_log.shapes.values())} GF products taking "
        f"{results['main_path_kernel_ms']} ms between their events, peak "
        f"{results['peak_mem_gib']:.2f} GiB")
    del sim, file_blocks, newcomer
    torch.cuda.empty_cache()

    # -- 3. kernel vs plain: mapping probes, every main-path shape, times ----
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)
    max_err = 0
    n_checked = 0

    def compare(a, b, label):
        nonlocal max_err, n_checked
        got = gf_matmul_cuda(a, b)
        want = gf_matmul_ref(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        max_err = max(max_err, err)
        n_checked += 1
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {label}: max err {err}")
        return got

    # The identity with single-bit payloads puts every fragment byte,
    # accumulator column and output byte where the layout says (N = 1000 is
    # a multiple of 8, N = 1001 takes the byte-wise variant); one set bit in
    # a zero payload lands in one output column.
    for kk in (1, 2, 3, 4, 5, 1024):
        eye = torch.eye(kk, dtype=torch.uint8, device=DEVICE)
        for n in (1000, 1001):
            for bit in range(8):
                b = torch.full((kk, n), 1 << bit, dtype=torch.uint8,
                               device=DEVICE)
                if not torch.equal(compare(eye, b, f"I_{kk}, bit {bit}"), b):
                    raise AssertionError(f"I . B != B at K={kk}, bit {bit}")
    a = rand_u8((9, 37), gen)
    for k0, n0, bit in [(0, 0, 0), (36, 511, 7), (5, 513, 3), (17, 1000, 6)]:
        for n in (1001, 1024):
            b = torch.zeros((37, n), dtype=torch.uint8, device=DEVICE)
            b[k0, min(n0, n - 1)] = 1 << bit
            compare(a, b, f"one bit at ({k0}, {n0}, {bit}), N={n}")
    for m, kk, n in [(1, 1, 1), (7, 13, 1_000_003), (33, 1024, 100_000),
                     (64, 1024, 4096), (5, 3, 17), (11, 48, 100_003)]:
        compare(rand_u8((m, kk), gen), rand_u8((kk, n), gen), (m, kk, n))
    base = rand_u8((1, 8 * 4096 + 4), gen)[0]
    compare(rand_u8((5, 8), gen), base[4:].view(8, 4096), "B at 4 bytes off")
    b = rand_u8((64, 1_000_000), gen)
    eye = torch.eye(64, dtype=torch.uint8, device=DEVICE)
    if not torch.equal(compare(eye, b, "identity"), b):
        raise AssertionError("I . B != B")
    zero = compare(torch.zeros((16, 64), dtype=torch.uint8, device=DEVICE),
                   b, "zeros")
    if zero.any():
        raise AssertionError("0 . B != 0")
    del b
    main_shapes = sorted(shape_log.shapes, key=lambda s: -s[0] * s[1] * s[2])
    for m, kk, n in main_shapes:
        compare(rand_u8((m, kk), gen), rand_u8((kk, n), gen), (m, kk, n))
        torch.cuda.empty_cache()
    # the plain bit-matrix version (the kernel's algorithm) on the card
    for m, kk, n in [(5, 3, 17), (48, 94, MIB)]:
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        if not torch.equal(gf_matmul_bitmatrix(a, b), gf_matmul_ref(a, b)):
            raise AssertionError(f"plain bit-matrix != plain at {(m, kk, n)}")
    log(f"kernel == plain on {n_checked} products (mapping probes, ragged "
        f"and unaligned shapes, {len(main_shapes)} main-path shapes), max "
        f"abs err {max_err}; plain bit-matrix == plain")

    rows = []
    for m, kk, n in main_shapes:
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        big = n >= MIB
        ms = cuda_ms(lambda: gf_matmul_cuda(a, b), 3 if big else 50)
        plain_ms = cuda_ms(lambda: gf_matmul_ref(a, b), 1 if big else 10)
        t_bytes, t_ops = bound_terms(m, kk, n)
        int8_ms = int8_gemm_ms(a, n, gen) if big and m >= 240 else None
        rows.append(dict(shape=[m, kk, n], calls=shape_log.shapes[(m, kk, n)],
                         main_path_ms=main_ms[(m, kk, n)],
                         ms=ms, plain_ms=plain_ms, int8_gemm_ms=int8_ms,
                         bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes,
                         ops_ms=t_ops,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
        log(f"  {m}x{kk}x{n}: {rows[-1]['calls']} calls, kernel {ms} ms, "
            f"plain {plain_ms} ms, bound {rows[-1]['bound_ms']} ms "
            f"({rows[-1]['bound_by']}), int8 GEMM {int8_ms} ms")
        del a, b
        torch.cuda.empty_cache()

    # `ms` is the main path's own launches, timed by the events around each
    # call; `plain_ms` and `bound_ms` cover the same work as each shape's
    # warm mean (or bound) times the number of calls the main path made at
    # that shape, and `ms_from_shapes` is the kernel's time on that footing.
    # `int8_gemm_ms` is torch._int_mm (cuBLASLt) on the kernel's own
    # bit-matrix product, for the shapes that have it: a yardstick that the
    # port never calls.
    total = {key: sum(r["calls"] * r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    gemm_rows = [r for r in rows if r["int8_gemm_ms"] is not None]
    kernels = [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "matches_plain": max_err == 0,
        "ms": results["main_path_kernel_ms"],
        "ms_from_shapes": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "int8_gemm_ms": sum(r["calls"] * r["int8_gemm_ms"] for r in gemm_rows),
        "int8_gemm_shapes": [r["shape"] for r in gemm_rows],
        "card": card,
        "shapes": rows,
    }]
    results["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
