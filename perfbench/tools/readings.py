#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's
own size: the control (the plain reference in the precision below the one
the configuration states, put in the program's place) and the program
with a fault planted.  The benchmark's own runs never run these.

    python3 perfbench/tools/readings.py control-train --seeds 1 2 3
    python3 perfbench/tools/readings.py control-plans --workload fig6-msr-d10.repair-b1 --seeds 1 2 3
    python3 perfbench/tools/readings.py fault --workload olmo-1b-ec8.train \
        --fault half_batch --seeds 1 2 3 [--seconds 2]

Each reading is printed as one JSON line (and appended to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def emit(out, row):
    print(json.dumps(row), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")


def control_train(args, manifest):
    """The reference in fp8 against the reference in fp32, on the weights
    and first batches the train cell draws, judged as the program is."""
    import numpy as np
    import torch
    from perfbench import gen
    from perfbench.common import gap, worst_leaf_gap
    from perfbench.reference import olmo
    from perfbench.run import cell_files
    cell, _, cfg, tr = cell_files(manifest, args.workload)
    mdl, opt = cfg["model"], cfg["optimizer"]
    dev = torch.device(args.device)
    wdt = getattr(torch, mdl["param_dtype"])
    for seed in args.seeds:
        batches = gen.lm_batches(seed, mdl["vocab_size"], cfg["batch"],
                                 cfg["seq_len"], 3, tr["markov_order"], dev)
        runs = {}
        for prec in ("fp32", "fp8"):
            params = gen.decoder_weights(mdl, seed, dev, wdt)
            runs[prec] = olmo.train_steps(params, mdl, opt, batches, prec)
            del params
        ref, ctl = runs["fp32"], runs["fp8"]
        med = float(np.median(ref["grad_norms"]))
        quiet = [g < 1e-3 * med for g in ref["grad_norms"]]
        emit(args.out, {
            "reading": "control-train", "seed": seed,
            "loss_gap": max(gap(a, b) for a, b in
                            zip(ctl["losses"], ref["losses"])),
            "grad_norm_gap": worst_leaf_gap(ctl["grad_norms"],
                                            ref["grad_norms"], quiet),
            "change_gap": worst_leaf_gap(ctl["change_norms"],
                                         ref["change_norms"], quiet),
            "losses": ref["losses"], "control_losses": ctl["losses"]})


def control_plans(args, manifest):
    """The plain planner on float32 capacities, its time rounded to
    float32, against the same planner in float64, on the cell's overlays
    (the configuration states float64 planning)."""
    import numpy as np
    from perfbench import gen
    from perfbench.common import gap
    from perfbench.reference import planners as ref
    from perfbench.run import cell_files
    cell, _, cfg, tr = cell_files(manifest, args.workload)
    code = cfg["code"]
    p = ref.CodeParams.msr(n=code["n"], k=code["k"], d=code["d"],
                           M=float(code["M"]))
    p32 = ref.CodeParams.msr(n=code["n"], k=code["k"], d=code["d"],
                             M=float(np.float32(code["M"])))
    for seed in args.seeds:
        caps = gen.capacities(gen.rng(seed, 6), cfg["judge"]["plans"],
                              code["d"], cfg["caps"])
        worst = 0.0
        for c in caps:
            want = ref.PLANNERS[cfg["scheme"]](ref.OverlayNetwork(c.tolist()),
                                               p).time
            c32 = c.astype(np.float32).astype(np.float64)
            got = ref.PLANNERS[cfg["scheme"]](
                ref.OverlayNetwork(c32.tolist()), p32).time
            worst = max(worst, gap(float(np.float32(got)), want))
        emit(args.out, {"reading": "control-plans", "seed": seed,
                        "plan_time_gap": worst})


def fault(args, manifest):
    """Whole runs of a cell (a short window) with a fault planted in the
    program, in this process."""
    from perfbench import run
    from perfbench.tools.faults import FAULTS
    _, _, _, tr = run.cell_files(manifest, args.workload)
    for seed in args.seeds:
        with FAULTS[tr["loop"]][args.fault]():
            import io
            import contextlib
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = run.main(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", str(args.seconds),
                               "--device", args.device])
        line = buf.getvalue().strip().splitlines()[-1] if rc == 0 else "{}"
        res = json.loads(line) if rc == 0 else {}
        emit(args.out, {"reading": f"fault-{args.fault}",
                        "workload": args.workload, "seed": seed, "rc": rc,
                        "correct": res.get("correct"),
                        "checks": {k: v["value"] for k, v in
                                   res.get("checks", {}).items()}})


def main(argv=None) -> int:
    from perfbench.run import read_json
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("control-train", "control-plans",
                                     "fault"))
    ap.add_argument("--workload", default="olmo-1b-ec8.train")
    ap.add_argument("--fault", default="half_batch")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = read_json(ROOT / "BENCHMARK.json")
    {"control-train": control_train, "control-plans": control_plans,
     "fault": fault}[args.what](args, manifest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
