#!/usr/bin/env python3
"""What the MoE's combine costs outside decode, between two trees of the
port (for example a parent commit unpacked with ``git archive`` and this
one): olmoe-1b-7b's prefill on one NVIDIA card, and the dry run's memory
at the MoE archs' cells on the host.

    python3 scripts/moe_combine_cost.py --tree parent=build/parent/src \\
        --tree change=src [--seed N] [--reps N] [--jobs N] [--out F]

Prefill: olmoe-1b-7b at its full width (bf16, random weights from
``--seed``), B = 1, 2,048 tokens into a cache of 2,048, each tree in its
own process, in the order A, B, B, A: one cold call, then ``--reps`` warm
calls, each timed by the host clock to a synchronize and by CUDA events;
the peak memory allocated above the model and cache during the warm calls;
the logits' largest |value| and their largest difference from the first
process's.  Dry run: ``python -m repro_torch.launch.dryrun`` of
kimi-k2-1t-a32b and olmoe-1b-7b at train_4k, prefill_32k and decode_32k on
16x16 and 2x16x16, a process per cell, ``--jobs`` at a time, after the
prefills (so they do not share the host with them), for both trees or
those named by ``--dryrun-tree`` (the counts are abstract, so an earlier
call's serve): each cell's ``ok``, temp bytes and peak bytes a device.
Prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ARCH = "olmoe-1b-7b"
TOKENS = 2048
DRYRUN_ARCHS = ("kimi-k2-1t-a32b", "olmoe-1b-7b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CELL_TIMEOUT = 1500


def prefill_worker(seed: int, reps: int, logits_out: str) -> dict:
    """One tree's prefill measurements (run with that tree's ``src`` on
    the path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill

    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (1, TOKENS), device=dev,
                         generator=gen)
    cache = init_cache(cfg, 1, TOKENS, dtype=torch.bfloat16, device=dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    host, event = [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for i in range(reps + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ev0.record()
        logits, _ = prefill(cfg, model, {"tokens": toks}, cache)
        ev1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        event.append(ev0.elapsed_time(ev1))
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    torch.save(logits.float().cpu(), logits_out)
    return dict(cold_ms=host[0], host_ms=host[1:], event_ms=event[1:],
                host_median_ms=statistics.median(host[1:]),
                event_median_ms=statistics.median(event[1:]),
                peak_gib=peak / 2**30, logit_max_abs=float(logits.abs().max()),
                torch=torch.__version__)


def run_prefills(trees: dict, seed: int, reps: int, out_dir: pathlib.Path
                 ) -> list:
    import torch
    names = list(trees)
    order = [names[0], names[1], names[1], names[0]]
    recs, first = [], None
    for i, name in enumerate(order):
        logits_out = out_dir / f"prefill_{i}_{name}.pt"
        env = dict(os.environ, PYTHONPATH=str(trees[name]))
        r = subprocess.run(
            [sys.executable, __file__, "--prefill-worker", "--seed",
             str(seed), "--reps", str(reps), "--logits-out", str(logits_out)],
            capture_output=True, text=True, env=env, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"prefill {name}: {r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        logits = torch.load(logits_out)
        if first is None:
            first = logits
        rec.update(tree=name, logit_max_abs_diff_from_first=float(
            (logits - first).abs().max()))
        print(f"prefill {name}: cold {rec['cold_ms']:.1f} ms, warm median "
              f"{rec['host_median_ms']:.2f} ms (events "
              f"{rec['event_median_ms']:.2f}), peak {rec['peak_gib']:.3f} "
              f"GiB, logits within {rec['logit_max_abs_diff_from_first']:g} "
              f"of the first run's", flush=True)
        recs.append(rec)
    return recs


def dryrun_cell(src: pathlib.Path, arch: str, shape: str, multi_pod: bool,
                out: pathlib.Path) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out)]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=str(src))
    t0 = time.perf_counter()
    out.unlink(missing_ok=True)
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CELL_TIMEOUT)
        err = r.stderr[-2000:]
    except subprocess.TimeoutExpired:
        err = f"timed out after {CELL_TIMEOUT} s"
    rec = json.loads(out.read_text()) if out.exists() else \
        dict(ok=False, error=err)
    mem = rec.get("memory", {})
    return dict(arch=arch, shape=shape,
                mesh="2x16x16" if multi_pod else "16x16", ok=rec["ok"],
                temp_bytes=mem.get("temp_bytes"),
                peak_bytes_per_device=mem.get("peak_bytes_per_device"),
                error=None if rec["ok"] else str(rec.get("error"))[-600:],
                seconds=time.perf_counter() - t0)


def run_dryruns(trees: dict, jobs: int, out_dir: pathlib.Path) -> list:
    work = [(name, arch, shape, mp) for arch in DRYRUN_ARCHS
            for shape in DRYRUN_SHAPES for mp in (False, True)
            for name in trees]
    with cf.ThreadPoolExecutor(jobs) as pool:
        futs = [pool.submit(dryrun_cell, trees[name], arch, shape, mp,
                            out_dir / f"dryrun_{name}_{arch}_{shape}_{mp}.json")
                for name, arch, shape, mp in work]
        recs = []
        for (name, *_), fut in zip(work, futs):
            rec = dict(tree=name, **fut.result())
            print(f"dryrun {name} {rec['arch']} x {rec['shape']} x "
                  f"{rec['mesh']}: ok={rec['ok']} temp {rec['temp_bytes']} B, "
                  f"peak {rec['peak_bytes_per_device']} B ({rec['seconds']:.0f}"
                  f" s)", flush=True)
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=SRC, twice")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--dryrun-tree", action="append", default=None,
                    help="dry-run only these trees (default: both)")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/moe_combine_cost.json"))
    ap.add_argument("--prefill-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--logits-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.prefill_worker:
        print(json.dumps(prefill_worker(args.seed, args.reps,
                                        args.logits_out)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("moe_combine_cost: CUDA is not available", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        ap.error("give --tree NAME=SRC twice")
    trees = {k: pathlib.Path(v).resolve() for k, v in trees.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out_dir = args.out.parent / "moe_combine_cost"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = dict(card=card, trees={k: str(v) for k, v in trees.items()},
               prefill=run_prefills(trees, args.seed, args.reps, out_dir))
    res["dryrun"] = run_dryruns(
        {k: v for k, v in trees.items()
         if args.dryrun_tree is None or k in args.dryrun_tree},
        args.jobs, out_dir)
    res["seconds"] = time.perf_counter() - t0
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
