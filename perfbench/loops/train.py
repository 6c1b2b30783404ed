"""Training with an erasure-coded checkpoint: a closed loop of train steps
through the program's ``TrainGraph``, with ``release()`` and
``ECCheckpoint.save`` every ``ckpt_every`` steps, in the order of
``repro_torch.train.loop.train`` (which takes neither given weights nor a
deadline, so its pieces are driven here).

Set-up draws the weights and batches from the seed, builds the one
runner the window uses and drives it through its first three steps (eager,
capture, replay) on rows that all differ, then saves the state once (the
window's save path, warm, and the save that is judged).  The window runs
steps until ``--seconds`` have passed.  Once it has closed and the program
is freed, the plain reference follows the first three steps from the same
weights and batches, and the saved shards are judged at sampled columns.
"""
from __future__ import annotations

import gc

import numpy as np

from perfbench import gen
from perfbench.common import (Context, device_trace, gap, now, span,
                              worst_leaf_gap)
from perfbench.gflog import ProductLog
from perfbench.reference import coded, olmo

FIRST_STEPS = 3


def _state(model, opt_state, step):
    return {"params": model.state_dict(), "opt": opt_state,
            "step": np.int32(step)}


def _state_leaves(model, opt_state, step, torch):
    """The state's leaves in the order its checkpoint stores them: the
    dict's keys sorted ("opt", "params", "step"), the optimizer state's
    fields in order (step, m, v), each mapping in its own order."""
    return ([opt_state.step] + list(opt_state.m.values())
            + list(opt_state.v.values()) + list(model.state_dict().values())
            + [torch.tensor(step, dtype=torch.int32,
                            device=opt_state.step.device)])


def run(ctx: Context):
    import torch
    from repro_torch.ft import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
    from repro_torch.kernels.ops import gf_matmul
    from repro_torch.models import ModelConfig, Transformer
    from repro_torch.train import (EagerTrainStep, OptimizerConfig,
                                   TrainGraph, init_opt)

    cfg, tr, rec, dev = ctx.config, ctx.traffic, ctx.record, ctx.device
    mdl, opt = cfg["model"], cfg["optimizer"]
    ck, limits = cfg["checkpoint"], cfg["limits"]
    mc = ModelConfig(**mdl)
    oc = OptimizerConfig(**opt)
    B, S, every = cfg["batch"], cfg["seq_len"], ck["ckpt_every"]
    wdt = getattr(torch, mdl["param_dtype"])

    batches = gen.lm_batches(ctx.seed, mdl["vocab_size"], B, S,
                             FIRST_STEPS + tr["batch_pool"],
                             tr["markov_order"], dev)

    def batch(step):
        i = step if step < FIRST_STEPS else \
            FIRST_STEPS + (step - FIRST_STEPS) % tr["batch_pool"]
        return {"tokens": batches[i][0], "labels": batches[i][1]}

    ctx.stamp("imports")
    model = Transformer(mc, dev)
    weights = gen.decoder_weights(mdl, ctx.seed, dev, wdt)
    with torch.no_grad():
        named = dict(model.named_parameters())
        if set(named) != set(weights):
            raise ValueError("the program's parameters are not the "
                             "configuration's")
        for n, p in named.items():
            p.copy_(weights[n])
    del weights
    opt_state = init_opt(oc, model, device=dev)
    runner = (TrainGraph if dev.type == "cuda" else EagerTrainStep)(
        mc, oc, model, opt_state, n_micro=cfg["n_micro"])
    products = ProductLog(gf_matmul)
    coder = ErasureCoder(n=ck["n"], k=ck["k"], d=ck["d"],
                         blocks_per_host=ck["blocks_per_host"],
                         seed=ctx.seed, device=dev, matmul=products)
    fleet = Fleet(FleetConfig(**ck["fleet"]), seed=ctx.seed)
    ckpt = ECCheckpoint(fleet, coder, hosts=ck["hosts"], seed=ctx.seed)

    ctx.stamp("state")
    # -- the first steps, through the window's own call ---------------------
    names = [n for n, _, _ in gen.decoder_leaves(mdl)]
    losses, grad_norms = [], None
    for step in range(FIRST_STEPS):
        metrics = runner(batch(step))
        losses.append(float(metrics["loss"]))
        if step == 0:       # the clipped gradient, from m = (1 - b1) g
            grad_norms = [float(torch.linalg.vector_norm(
                opt_state.m[n].float())) / (1 - oc.b1) for n in names]
    del metrics
    start = gen.decoder_weights(mdl, ctx.seed, dev, wdt)
    with torch.no_grad():
        change_norms = [float(torch.linalg.vector_norm(
            named[n].float() - start[n].float())) for n in names]
    del start

    ctx.stamp("first steps")
    # -- one save: the window's path, warm, and the checkpoint judged -------
    runner.release()
    ckpt.save(_state(model, opt_state, FIRST_STEPS), FIRST_STEPS)
    ctx.sync()
    group = ckpt.group
    cols = gen.sample_columns(gen.rng(ctx.seed, 5), group.block_bytes,
                              ck["judge_columns"])
    saved_cols = coded.stream_columns(
        _state_leaves(model, opt_state, FIRST_STEPS, torch), coder.M,
        group.block_bytes, cols).cpu()
    shard_vectors = torch.cat([group.shards[h].vectors.cpu()
                               for h in ck["hosts"]])
    shard_cols = coded.gather_columns(
        [group.shards[h].payload for h in ck["hosts"]], cols)
    del group
    ctx.stamp("save")

    # -- the window -----------------------------------------------------------
    products.on = ctx.trace
    timing = dev.type == "cuda"
    replays, kinds = [], []
    step = FIRST_STEPS
    traced = None
    t_start = ctx.open_window()
    while True:
        if ctx.trace and traced is None and (step + 2) % every == 0 \
                and step > FIRST_STEPS:
            traced = device_trace(ctx, "train")
            traced.__enter__()
        captures = runner.graph is None if timing else False
        t0 = now()
        if timing:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with span("train.step"):
            metrics = runner(batch(step))
            if timing:
                e1.record()
            float(metrics["loss"])
        rec.samples["step_s"].append(now() - t0)
        kinds.append("capture" if captures else "replay")
        if timing and not captures:
            replays.append((e0, e1))
        del metrics
        rec.attempted += 1
        if (step + 1) % every == 0:
            t0 = now()
            with span("ckpt.save"):
                runner.release()
                ckpt.save(_state(model, opt_state, step + 1), step + 1)
                ctx.sync()
            rec.samples["save_s"].append(now() - t0)
            if traced is not None and rec.trace is None:
                traced.__exit__(None, None, None)
        step += 1
        if now() - t_start >= ctx.seconds:
            break
    t_end = now()
    if traced is not None and rec.trace is None:
        traced.__exit__(None, None, None)
    ctx.sync()

    rec.values["tokens"] = (step - FIRST_STEPS) * B * S
    rec.values["window_s"] = t_end - t_start
    rec.samples["replay_event_s"] = [a.elapsed_time(b) / 1e3
                                     for a, b in replays]
    replay_s = [t for t, k in zip(rec.samples["step_s"], kinds)
                if k == "replay"]
    rec.samples["replay_host_s"] = replay_s
    rec.samples["capture_call_s"] = [t for t, k in zip(rec.samples["step_s"],
                                                       kinds)
                                     if k == "capture"]
    rec.samples["gf_products"] = products.readings()
    rec.notes.append(f"steps {step - FIRST_STEPS}, saves (s) "
                     f"{[round(t, 3) for t in rec.samples['save_s']]}, "
                     f"capture calls (s) "
                     f"{[round(t, 3) for t in rec.samples['capture_call_s']]}")
    if dev.type == "cuda":
        rec.values["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    # -- the program freed, the reference follows the first steps -----------
    del runner, model, opt_state, ckpt, coder, fleet, named, products
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = now()
    params = gen.decoder_weights(mdl, ctx.seed, dev, wdt)
    ref = olmo.train_steps(params, mdl, opt,
                           [batches[i] for i in range(FIRST_STEPS)])
    del params
    rec.values["reference_s"] = now() - t0
    med = float(np.median(ref["grad_norms"]))
    quiet = [g < 1e-3 * med for g in ref["grad_norms"]]
    rec.values["leaves_left_out"] = sum(quiet)
    rec.check("loss_gap", max(gap(a, b) for a, b in
                              zip(losses, ref["losses"])),
              limits["loss_gap"])
    rec.check("grad_norm_gap", worst_leaf_gap(grad_norms, ref["grad_norms"],
                                              quiet),
              limits["grad_norm_gap"])
    rec.check("change_gap", worst_leaf_gap(change_norms,
                                           ref["change_norms"], quiet),
              limits["change_gap"])
    rec.check("ckpt_wrong_bytes",
              coded.wrong_bytes(shard_vectors, shard_cols, saved_cols),
              limits["ckpt_wrong_bytes"])
    rec.values["losses"] = losses
    rec.values["reference_losses"] = ref["losses"]
    return rec
