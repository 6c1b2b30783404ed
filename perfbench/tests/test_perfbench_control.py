"""The controls, at a size a test can hold: the plain reference in the
precision below the configuration's, put in the program's place, fails at
least one of the cell's limits.  (On the card, at the cells' own sizes:
``perfbench/tools/readings.py``.)"""
import numpy as np
import torch

from perfbench import gen
from perfbench.common import gap, worst_leaf_gap
from perfbench.reference import olmo
from perfbench.reference import planners as ref
from perfbench.run import ROOT, read_json
from perfbench_cpu import TINY_DECODER


def test_fp8_reference_fails_the_train_limits():
    cfg = read_json(ROOT / "perfbench/configs/olmo-1b-ec8.json")
    mdl = dict(TINY_DECODER, param_dtype="bfloat16",
               compute_dtype="bfloat16")
    batches = gen.lm_batches(5, mdl["vocab_size"], 2, 32, 3, 0.9, "cpu")
    runs = {}
    for prec in ("fp32", "fp8"):
        params = gen.decoder_weights(mdl, 5, "cpu", torch.bfloat16)
        runs[prec] = olmo.train_steps(params, mdl, cfg["optimizer"],
                                      batches, prec)
    ref32, ctl = runs["fp32"], runs["fp8"]
    readings = {
        "loss_gap": max(gap(a, b) for a, b in zip(ctl["losses"],
                                                  ref32["losses"])),
        "grad_norm_gap": worst_leaf_gap(ctl["grad_norms"],
                                        ref32["grad_norms"]),
        "change_gap": worst_leaf_gap(ctl["change_norms"],
                                     ref32["change_norms"])}
    assert any(v > cfg["limits"][k] for k, v in readings.items()), readings


def test_float32_planner_fails_the_plan_limit():
    cfg = read_json(ROOT / "perfbench/configs/fig6-msr-d10.json")
    code = cfg["code"]
    p = ref.CodeParams.msr(n=code["n"], k=code["k"], d=code["d"],
                           M=float(code["M"]))
    caps = gen.capacities(gen.rng(7, 6), 3, code["d"], cfg["caps"])
    worst = 0.0
    for c in caps:
        want = ref.plan_ftr(ref.OverlayNetwork(c.tolist()), p).time
        c32 = c.astype(np.float32).astype(np.float64)
        got = ref.plan_ftr(ref.OverlayNetwork(c32.tolist()), p).time
        worst = max(worst, gap(float(np.float32(got)), want))
    assert worst > cfg["limits"]["plan_time_gap"]
