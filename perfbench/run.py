#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is ``configs/<config>.json`` and its traffic
``traffic/<traffic>.json``; the traffic names the loop
(``loops/<loop>.py``) that drives the program, and each metric is read by
``metrics/<name>.py``.  Everything is found by name, so a cell, a traffic
mix or a metric is added by adding files and manifest entries.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and traced seconds
and a breakdown of the traced part.  The checks that decide ``correct``
are printed last on standard error and last in the line.  Exits 2 without
as many CUDA devices as the cell asks for, and 3 if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str):
    """The cell's entry, its configuration's entry, and the parsed
    configuration and traffic files."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = read_json(ROOT / conf["file"])
    traffic = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, conf, config, traffic


def set_environment() -> None:
    """Every cache the program or its libraries build into, at a fixed
    directory inside the checkout, before torch is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "torchinductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def metrics_of(manifest: dict, cell: dict, trace: bool) -> list:
    """The metric entries this run reports: the cell's end-to-end metrics,
    or with ``trace`` the per-layer metrics listed for the cell (or, with
    no list, for every cell that reports the metric they move)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    manifest = read_json(ROOT / "BENCHMARK.json")
    cell, _, config, traffic = cell_files(manifest, args.workload)
    for key, val in (overrides or {}).items():     # the CPU tests' sizes
        (traffic if key in traffic else config)[key] = val
    set_environment()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from perfbench.common import Context, analyse_profile

    chips = cell["chips"]
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.cuda.reset_peak_memory_stats()
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    loop = load_module(HERE / "loops" / f"{traffic['loop']}.py",
                       f"perfbench_loop_{traffic['loop']}")
    ctx = Context(cell=cell["name"], config=config,
                  traffic=traffic, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device)
    rec = loop.run(ctx)

    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if rec.trace is not None and "prof" in rec.trace:
        trace = rec.trace
        rec.trace = analyse_profile(trace["prof"], trace["window_s"])
        rec.trace["label"] = trace["label"]

    metrics = {}
    for m in metrics_of(manifest, cell, bool(args.trace)):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec, ctx)
        if value is None:
            if not args.trace:
                print(f"no reading for {m['name']}", file=sys.stderr)
                return 4
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": chips,
               "memory_peak_bytes": int(rec.values.get(
                   "memory_peak_bytes",
                   torch.cuda.max_memory_allocated(device))),
               "power_limit": power_limit()}
    else:
        dev = {"platform": device.type, "kind": "host", "count": 0,
               "memory_peak_bytes": 0}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if args.trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in rec.checks}
    if ctx.stamps:
        print("set-up: " + ", ".join(f"{n} {t}" for n, t in ctx.stamps),
              file=sys.stderr)
    for key in ("reference_s", "memory_peak_bytes"):
        if key in rec.values:
            print(f"{key} {rec.values[key]!r}", file=sys.stderr)
    for note in rec.notes[-40:]:
        print(note, file=sys.stderr)
    for err in rec.errors[:5]:
        print(f"error: {err}", file=sys.stderr)
    for c in rec.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
