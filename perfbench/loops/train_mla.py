"""Training a share of DeepSeek-V2 with an erasure-coded checkpoint: the
``train_moe`` loop's closed loop of ``TrainGraph`` steps, with
``release()`` and ``ECCheckpoint.save`` every ``ckpt_every`` steps, on an
``MLAShareConfig`` model (multi-head latent attention on the fused
kernel's (192, 128) variant, a leading dense layer, then DeepSeekMoE
layers: the dropless top-K share of the routed experts beside the shared
experts, the sequence-wise balance loss).

Set-up draws the weights (``gen_mla``) and batches from the seed, builds
the one runner the window uses and drives it through its first three
steps (eager, capture, replay), recording the first step's held choices
(``MoEShare.routes`` of each MoE layer), then saves the state once.  The
window runs steps until ``--seconds`` have passed; in the traced run the
device times of the MoE layers (``moe``: the routed share and the shared
experts), the MLA blocks (``mla``) and the attention calls inside them
(``attn.mla``) of each replay are read from the program
(``obs.spans.timed``'s events, captured into the graph).  The device
totals ``moe.pairs`` and ``moe.dropped`` are read before and after the
window.  Once the program is freed, the plain reference
(``reference/deepseek_v2.py``) follows the first three steps from the
same weights and batches; the judge is ``train_moe``'s: the losses, the
first gradient's and the change's norms per leaf, the coded save, the
held choices that differ (``route_gap``) and the dropped pairs
(``dropped_pairs``, exact 0).
"""
from __future__ import annotations

import gc

import numpy as np

from perfbench import gen, gen_mla
from perfbench.common import (Context, device_trace, gap, now, span,
                              worst_leaf_gap)
from perfbench.gflog import ProductLog
from perfbench.loops.train import FIRST_STEPS, _state, _state_leaves
from perfbench.loops.train_moe import route_gap
from perfbench.reference import coded, deepseek_v2

# the program's device times read after each replay of the traced run
DEVICE_TIMES = {"moe": "moe_event_s", "mla": "mla_event_s",
                "attn.mla": "attn_mla_event_s"}


def run(ctx: Context):
    import torch
    from repro_torch.models import MLAShareConfig, Transformer
    from repro_torch.obs import spans
    from repro_torch.ft import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
    from repro_torch.kernels.ops import gf_matmul
    from repro_torch.train import (EagerTrainStep, OptimizerConfig,
                                   TrainGraph, init_opt)

    cfg, tr, rec, dev = ctx.config, ctx.traffic, ctx.record, ctx.device
    mdl, opt = cfg["model"], cfg["optimizer"]
    ck, limits = cfg["checkpoint"], cfg["limits"]
    mc = MLAShareConfig(**mdl)
    oc = OptimizerConfig(**opt)
    B, S, every = cfg["batch"], cfg["seq_len"], ck["ckpt_every"]
    wdt = getattr(torch, mdl["param_dtype"])
    timing = dev.type == "cuda"
    spans.time_device(ctx.trace and timing)

    batches = gen.lm_batches(ctx.seed, mdl["vocab_size"], B, S,
                             FIRST_STEPS + tr["batch_pool"],
                             tr["markov_order"], dev)

    def batch(step):
        i = step if step < FIRST_STEPS else \
            FIRST_STEPS + (step - FIRST_STEPS) % tr["batch_pool"]
        return {"tokens": batches[i][0], "labels": batches[i][1]}

    ctx.stamp("imports")
    model = Transformer(mc, dev)
    weights = gen_mla.mla_weights(mdl, ctx.seed, dev, wdt)
    with torch.no_grad():
        named = dict(model.named_parameters())
        if set(named) != set(weights):
            raise ValueError("the program's parameters are not the "
                             "configuration's")
        for n, p in named.items():
            p.copy_(weights[n])
    del weights
    opt_state = init_opt(oc, model, device=dev)
    runner = (TrainGraph if timing else EagerTrainStep)(
        mc, oc, model, opt_state, n_micro=cfg["n_micro"])
    products = ProductLog(gf_matmul)
    coder = ErasureCoder(n=ck["n"], k=ck["k"], d=ck["d"],
                         blocks_per_host=ck["blocks_per_host"],
                         seed=ctx.seed, device=dev, matmul=products)
    fleet = Fleet(FleetConfig(**ck["fleet"]), seed=ctx.seed)
    ckpt = ECCheckpoint(fleet, coder, hosts=ck["hosts"], seed=ctx.seed)
    layers = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]

    ctx.stamp("state")
    # -- the first steps, through the window's own call ---------------------
    names = [n for n, *_ in gen_mla.mla_leaves(mdl)]
    losses, parts, grad_norms = [], [], None
    for layer in layers:
        layer.routes = []
    for step in range(FIRST_STEPS):
        if timing and runner.warm and runner.graph is None:
            spans.clear_device_times()
        metrics = runner(batch(step))
        losses.append(float(metrics["loss"]))
        parts.append({k: float(metrics[k]) for k in ("xent", "lb_loss")})
        if step == 0:       # the clipped gradient, from m = (1 - b1) g
            grad_norms = [float(torch.linalg.vector_norm(
                opt_state.m[n].float())) / (1 - oc.b1) for n in names]
            # under remat a block runs twice a microbatch: the forward,
            # then its recomputation in the backward
            routes = [layer.routes[::2] if mc.remat else layer.routes
                      for layer in layers]
            for layer in layers:
                layer.routes = None
    del metrics
    start = gen_mla.mla_weights(mdl, ctx.seed, dev, wdt)
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
    replays, kinds = [], []
    step = FIRST_STEPS
    traced = None
    pairs0 = spans.device_total("moe.pairs")
    dropped0 = spans.device_total("moe.dropped")
    t_start = ctx.open_window()
    while True:
        if ctx.trace and traced is None and (step + 2) % every == 0 \
                and step > FIRST_STEPS:
            traced = device_trace(ctx, "train")
            traced.__enter__()
        captures = runner.graph is None if timing else False
        if captures:
            spans.clear_device_times()
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
            if ctx.trace:
                for name, key in DEVICE_TIMES.items():
                    rec.samples[key].append(spans.device_ms(name) / 1e3)
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

    steps = step - FIRST_STEPS
    rec.values["tokens"] = steps * B * S
    rec.values["window_s"] = t_end - t_start
    rec.values["pairs_per_step"] = \
        (spans.device_total("moe.pairs") - pairs0) / steps
    dropped = spans.device_total("moe.dropped") - dropped0
    rec.samples["replay_event_s"] = [a.elapsed_time(b) / 1e3
                                     for a, b in replays]
    rec.samples["replay_host_s"] = [t for t, k in zip(rec.samples["step_s"],
                                                      kinds) if k == "replay"]
    rec.samples["capture_call_s"] = [t for t, k in zip(rec.samples["step_s"],
                                                       kinds)
                                     if k == "capture"]
    rec.samples["gf_products"] = products.readings()
    per_token = rec.values["pairs_per_step"] / (B * S * len(layers))
    rec.notes.append(f"steps {steps}, saves (s) "
                     f"{[round(t, 3) for t in rec.samples['save_s']]}, "
                     f"capture calls (s) "
                     f"{[round(t, 3) for t in rec.samples['capture_call_s']]}"
                     f", held pairs a token and MoE layer {per_token:.4f}")
    if timing:
        rec.values["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    spans.time_device(False)
    spans.clear_device_times()

    # -- the program freed, the reference follows the first steps -----------
    del runner, model, opt_state, ckpt, coder, fleet, named, products, layers
    gc.collect()
    if timing:
        torch.cuda.empty_cache()
    t0 = now()
    params = gen_mla.mla_weights(mdl, ctx.seed, dev, wdt)
    ref = deepseek_v2.train_steps(params, mdl, opt,
                                  [batches[i] for i in range(FIRST_STEPS)],
                                  cfg["n_micro"])
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
    rec.check("route_gap",
              route_gap([r for layer in routes for r in layer],
                        [r for layer in ref["routes"] for r in layer],
                        mc.router_experts),
              limits["route_gap"])
    rec.check("dropped_pairs", dropped, limits["dropped_pairs"])
    rec.values["losses"] = losses
    rec.values["reference_losses"] = ref["losses"]
    rec.notes.append(f"loss parts {parts[0]}, reference "
                     f"{ {k: ref['parts'][0][k] for k in parts[0]} }")
    return rec
