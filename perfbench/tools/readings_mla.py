#!/usr/bin/env python3
"""The readings that the limits of the DeepSeek-V2-Lite train cell are set
from, at its own size (``readings_moe.py``'s, for the ``train_mla``
loop): the control (the plain reference in fp8, the precision below the
configuration's bf16, put in the program's place), the program with a
fault planted (``faults_mla.FAULTS_MLA``), and sound runs (``--fault
none``).

    python3 perfbench/tools/readings_mla.py control --seeds 1 2 3
    python3 perfbench/tools/readings_mla.py fault --fault no_mscale \
        --seeds 1 2 3 [--seconds 2]

Each reading is printed as one JSON line (and appended to ``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.tools.readings import emit  # noqa: E402

CELL = "deepseek-v2-lite-ec8.train-mla"


def control(args, manifest):
    """The reference in fp8 against the reference in fp32, on the weights
    and first batches the cell draws, judged as the program is."""
    import numpy as np
    import torch
    from perfbench import gen, gen_mla
    from perfbench.common import gap, worst_leaf_gap
    from perfbench.loops.train_moe import route_gap
    from perfbench.reference import deepseek_v2
    from perfbench.run import cell_files
    _, _, cfg, tr = cell_files(manifest, CELL)
    mdl, opt = cfg["model"], cfg["optimizer"]
    dev = torch.device(args.device)
    wdt = getattr(torch, mdl["param_dtype"])
    for seed in args.seeds:
        batches = gen.lm_batches(seed, mdl["vocab_size"], cfg["batch"],
                                 cfg["seq_len"], 3, tr["markov_order"], dev)
        runs = {}
        for prec in ("fp32", "fp8"):
            params = gen_mla.mla_weights(mdl, seed, dev, wdt)
            runs[prec] = deepseek_v2.train_steps(params, mdl, opt, batches,
                                                 cfg["n_micro"], prec)
            del params
        ref, ctl = runs["fp32"], runs["fp8"]
        med = float(np.median(ref["grad_norms"]))
        quiet = [g < 1e-3 * med for g in ref["grad_norms"]]
        emit(args.out, {
            "reading": "control-train-mla", "seed": seed,
            "loss_gap": max(gap(a, b) for a, b in
                            zip(ctl["losses"], ref["losses"])),
            "grad_norm_gap": worst_leaf_gap(ctl["grad_norms"],
                                            ref["grad_norms"], quiet),
            "change_gap": worst_leaf_gap(ctl["change_norms"],
                                         ref["change_norms"], quiet),
            "route_gap": route_gap(
                [r for layer in ctl["routes"] for r in layer],
                [r for layer in ref["routes"] for r in layer],
                mdl["router_experts"]),
            "losses": ref["losses"], "control_losses": ctl["losses"],
            "parts": ref["parts"][0]})


def fault(args, manifest):
    """Whole runs of the cell (a short window) with a fault planted in the
    program (none with ``--fault none``), in this process."""
    from perfbench import run
    from perfbench.tools.faults_mla import FAULTS_MLA
    plant = contextlib.nullcontext if args.fault == "none" \
        else FAULTS_MLA[args.fault]
    for seed in args.seeds:
        buf = io.StringIO()
        with plant(), contextlib.redirect_stdout(buf):
            rc = run.main(["--workload", CELL, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--device",
                           args.device])
        res = json.loads(buf.getvalue().strip().splitlines()[-1]) \
            if rc == 0 else {}
        emit(args.out, {"reading": f"fault-{args.fault}", "workload": CELL,
                        "seed": seed, "rc": rc,
                        "correct": res.get("correct"),
                        "checks": {k: v["value"] for k, v in
                                   res.get("checks", {}).items()}})


def main(argv=None) -> int:
    from perfbench.run import read_json
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("control", "fault"))
    ap.add_argument("--fault", default="no_mscale")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = read_json(ROOT / "BENCHMARK.json")
    {"control": control, "fault": fault}[args.what](args, manifest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
