"""Bulk planning: a closed loop of ``core.plan_many`` calls on the card,
each over ``batch`` overlays drawn from the seed (the paper's Monte Carlo,
a fleet's epoch).  No coded byte moves.

Set-up draws a pool of batches onto the card and plans one to warm every
path; the window cycles through the pool.  After the window the judge
holds a sample of lanes, drawn from the seed over every call, to the
plain scalar planner and checks their structure.
"""
from __future__ import annotations

from perfbench import gen
from perfbench.common import Context, device_trace, now, span
from perfbench.loops.repair import code_params, judge_plans


def run(ctx: Context):
    import torch
    from repro_torch import core
    from repro_torch.core import torch_engine

    cfg, tr, rec, dev = ctx.config, ctx.traffic, ctx.record, ctx.device
    code, limits, scheme = cfg["code"], cfg["limits"], cfg["scheme"]
    params = code_params(core, code)
    ctx.stamp("imports")
    draws = gen.rng(ctx.seed, 8)
    pool = [gen.capacities(draws, tr["batch"], code["d"], cfg["caps"])
            for _ in range(tr["pool"])]
    on_card = [torch.from_numpy(c).to(dev) for c in pool]

    results = []

    def call(i, timed):
        syncs = torch_engine.syncs
        with span("plan.call"):
            res = core.plan_many(on_card[i % len(pool)], params, scheme,
                                 device=dev)
            ctx.sync()
        if timed:
            rec.samples["call_syncs"].append(torch_engine.syncs - syncs)
            results.append((i % len(pool), res))

    call(0, False)
    calls = 0
    ctx.open_window()
    t0 = now()
    while ctx.window_left() > 0:
        rec.attempted += 1
        if ctx.trace and calls == 1:
            with device_trace(ctx, "plan"):
                call(calls, True)
        else:
            call(calls, True)
        calls += 1
    rec.values["window_s"] = now() - t0
    rec.values["plans"] = calls * tr["batch"]
    if dev.type == "cuda":
        rec.values["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    # -- the judge: lanes drawn from the seed over every call ----------------
    jr = gen.rng(ctx.seed, 9)
    count = cfg["judge"]["plans"]
    which = jr.integers(len(results), size=count)
    lanes = jr.integers(tr["batch"], size=count)
    drawn, plans = [], []
    for w, lane in zip(which, lanes):
        p, res = results[int(w)]
        one = core.BatchPlanResult(
            **{f: (getattr(res, f)[int(lane):int(lane) + 1]
                   if isinstance(getattr(res, f), torch.Tensor)
                   else getattr(res, f))
               for f in res.__dataclass_fields__})
        [pl] = core.plans_from_batch(one, params)
        drawn.append(pool[p][int(lane)])
        plans.append(pl)
    t0 = now()
    judge_plans(rec, drawn, plans, code, scheme, limits, range(len(plans)))
    rec.values["reference_s"] = now() - t0
    return rec
