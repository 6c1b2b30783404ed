#!/usr/bin/env python3
"""Where one training step of OLMoE's expert share goes on one NVIDIA
card, at the benchmark's shapes (``perfbench/configs/olmoe-1b-7b-ec8.json``):
device ms by category, eager and as a graph replay, beside the device
times that the program's events read in a replay.

    python3 scripts/moe_profile.py [--seed N] [--layers L] [--out F]

Builds the ``MoEShareConfig`` model with the benchmark's weights and
batches for ``--seed`` (``perfbench.gen_moe``, ``perfbench.gen``), AdamW,
and one ``TrainGraph`` of the configuration's microbatches; runs the
eager first step, the capture and a replay with ``obs.spans.time_device``
on, then profiles an eager step of the same state (``EagerTrainStep``,
its events on too, so that its autograd runs in the graph's order) and a
replay with ``chip_smoke.step_profile``.  Its categories are
``chip_smoke``'s, each kernel of the MoE's spans
(``moe.route``, ``moe.aux``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``: a kernel goes to the innermost span around the op that
launched it, or in the backward to that of the forward op that made its
autograd node) under its span, ``"<span>: <category>"`` where
``chip_smoke`` gives it one other than ``other``, and the kernels of
``aten::_grouped_mm`` and of its backward's other ops apart.  The
replay's events take the eager step's categories in order.  Beside them,
the unprofiled replay's event times (``events_ms``): ``moe`` (every MoE
layer), ``moe.products`` (each grouped product) and ``moe.experts`` (the experts'
region, the three products and the SwiGLU between them, timed by this
script).  Prints the card, each profile's summary and, last, one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from perfbench import gen, gen_moe
    from repro_torch.models import MoEShareConfig, Transformer, moe
    from repro_torch.obs import spans
    from repro_torch.train import (EagerTrainStep, OptimizerConfig,
                                   TrainGraph, init_opt)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    cfg = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
                     .read_text())
    mdl = dict(cfg["model"])
    if args.layers:
        mdl["num_layers"] = args.layers
    mc = MoEShareConfig(**mdl)
    oc = OptimizerConfig(**cfg["optimizer"])
    dev = torch.device("cuda", 0)
    model = Transformer(mc, dev)
    w = gen_moe.moe_weights(mdl, args.seed, dev, torch.bfloat16)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    del w
    opt = init_opt(oc, model, device=dev)
    graph = TrainGraph(mc, oc, model, opt, n_micro=cfg["n_micro"])
    eager = EagerTrainStep(mc, oc, model, opt, n_micro=cfg["n_micro"])
    batches = gen.lm_batches(args.seed, mdl["vocab_size"], cfg["batch"],
                             cfg["seq_len"], 2, 0.9, dev)
    batch = {"tokens": batches[0][0], "labels": batches[0][1]}
    experts = moe.MoEShare.experts

    def timed_experts(self, xs, offs):
        return spans.timed("moe.experts", lambda x: experts(self, x, offs),
                           xs)
    moe.MoEShare.experts = timed_experts
    spans.time_device(True)
    step_ms = []
    for _ in range(3):
        if graph.warm and graph.graph is None:
            spans.clear_device_times()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(graph(batch)["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # the replay's events now: the eager step below records its own
    events_ms = {n: spans.device_ms(n)
                 for n in ("moe", "moe.experts", "moe.products")}
    print("graph calls (eager, capture, replay) ms:",
          [round(t, 1) for t in step_ms], flush=True)

    orig_category = cs._category

    def moe_of(op, fwd_ops):
        """The innermost MoE span around ``op``, or around the forward op
        of the autograd node that ``op`` runs under."""
        while op is not None:
            if op.name.startswith("moe."):
                return op.name
            if op.name.startswith("autograd::engine::evaluate_function"):
                fwd = fwd_ops.get((op.sequence_nr, op.fwd_thread))
                return None if fwd is None else moe_of(fwd, fwd_ops)
            op = op.cpu_parent
        return None

    def grouped(op):
        """Whether ``op`` is (under) a grouped product or its backward."""
        while op is not None and not op.name.startswith("moe."):
            if op.name == "aten::_grouped_mm":
                return "grouped products"
            if op.name.startswith("autograd::engine::evaluate_function"):
                return ("grouped products' backward, other ops"
                        if "GroupedMm" in op.name else None)
            op = op.cpu_parent
        return None

    def category(op, fwd_ops, dtypes):
        got = orig_category(op, fwd_ops, dtypes)
        where = moe_of(op, fwd_ops)
        if where is None:
            return got
        part = grouped(op) or (None if got == "other" else got)
        return f"{where}: {part}" if part else where
    cs._category = category
    like = cs.step_profile(lambda: eager(batch))
    print(cs.profile_line("eager step", like), flush=True)
    replay = cs.step_profile(lambda: graph(batch), like=like)
    spans.time_device(False)
    print(cs.profile_line("replay", replay), flush=True)
    for rec in (like, replay):
        rec.pop("order", None)
    cats = replay["categories"]
    experts_ms = {c: v["ms"] for c, v in cats.items()
                  if c.startswith("moe.experts")}
    print("replay: events ms", {n: round(t, 2) for n, t in
                                events_ms.items()},
          "; the experts' kernels by category ms",
          {c: round(t, 2) for c, t in experts_ms.items()},
          f"(sum {sum(experts_ms.values()):.2f}); every MoE span's "
          f"{sum(v['ms'] for c, v in cats.items() if c.startswith('moe.')):.2f}",
          flush=True)
    out = dict(card=card, torch=torch.__version__, layers=mc.num_layers,
               graph_calls_ms=step_ms, eager=like, replay=replay,
               events_ms=events_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
