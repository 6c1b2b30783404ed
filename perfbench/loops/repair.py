"""Single repairs of a storage cluster: a closed loop, one lost node at a
time.  For each repair the benchmark draws from the seed a failed node and d
providers among the survivors, and takes the next overlay of link
capacities from a fixed pool in an order drawn from the seed.  Every seed
draws from the same pool, so the tail moves little with the seed, and the
pool is larger than the repairs a window holds, so no overlay comes twice
in a run (a run that plans more counts its repeats in its notes).  The
node's payload is lost (zeroed), and the program plans the repair at
B = 1 on the card (``core.plan_many``) and executes it through the GF(2^8)
kernel (``RlncSimulator.execute_plan``), the order of
``RlncSimulator.repair_round``.  A repair's time runs from the loss to the
newcomer holding its regenerated blocks, ended by a synchronize; the
window's length runs to the end of the last repair it started.

Set-up makes the file on the card from the seed, distributes it (the
program's encode) and runs two repairs to warm every path.  After the
window the judge checks a sample of the window's plans against the plain
scalar planner, every plan's structure, and the coded bytes of every node
at sampled columns against the file.
"""
from __future__ import annotations

import random

from perfbench import gen
from perfbench.common import Context, device_trace, gap, now, span
from perfbench.gflog import ProductLog
from perfbench.reference import coded
from perfbench.reference import planners as ref

WARM_REPAIRS = 2


def code_params(core, code: dict):
    if code["point"] != "msr":
        raise ValueError(f"unknown point {code['point']!r}")
    return core.CodeParams.msr(n=code["n"], k=code["k"], d=code["d"],
                               M=float(code["M"]))


def judge_plans(rec, drawn, plans, code, scheme, limits, picks):
    """Every plan's structure (a tree over the providers, flows as the
    betas give them, its time at least what its flows take), and the time
    of the picked plans against the plain planner's."""
    p = ref.CodeParams.msr(n=code["n"], k=code["k"], d=code["d"],
                           M=float(code["M"]))
    invalid = 0
    for caps, pl in zip(drawn, plans):
        net = ref.OverlayNetwork(caps.tolist())
        mine = ref.RepairPlan(scheme=pl.scheme, params=p,
                              parent=dict(pl.parent), betas=list(pl.betas),
                              flows=dict(pl.flows), time=float(pl.time))
        try:
            mine.validate(net)
            if abs(mine.time - ref.plan_time(mine, net)) > \
                    1e-9 * max(1.0, mine.time):
                raise AssertionError("time overstated")
        except (AssertionError, KeyError):
            invalid += 1
    worst = 0.0
    for i in picks:
        want = ref.PLANNERS[scheme](ref.OverlayNetwork(drawn[i].tolist()), p)
        worst = max(worst, gap(float(plans[i].time), want.time))
    rec.check("plans_invalid", invalid, limits["plans_invalid"])
    rec.check("plan_time_gap", worst, limits["plan_time_gap"])


def run(ctx: Context):
    import torch
    from repro_torch import core
    from repro_torch.coding import GF8, RLNC
    from repro_torch.kernels.ops import gf_matmul
    from repro_torch.obs.profile import PlannerProfile
    from repro_torch.storage.simulator import RlncSimulator

    cfg, tr, rec, dev = ctx.config, ctx.traffic, ctx.record, ctx.device
    code, limits, scheme = cfg["code"], cfg["limits"], cfg["scheme"]
    n, d, M = code["n"], code["d"], code["M"]
    params = code_params(core, code)
    alpha = int(round(params.alpha))
    if tr["batch"] != 1:
        raise ValueError("the repair loop plans one repair a call")

    ctx.stamp("imports")
    file_blocks = torch.randint(0, 256, (M, cfg["block_bytes"]),
                                dtype=torch.uint8, device=dev,
                                generator=gen.device_generator(ctx.seed, 3,
                                                               dev))
    products = ProductLog(gf_matmul)
    np_rng = gen.rng(ctx.seed, 4)
    rl = RLNC(GF8, matmul=products, device=dev)
    nodes = dict(enumerate(rl.distribute(file_blocks, n, alpha, np_rng)))
    sim = RlncSimulator.from_state(params, file_blocks, nodes, np_rng,
                                   random.Random(ctx.seed), matmul=products,
                                   device=dev)
    ctx.stamp("file coded")
    draws = gen.rng(ctx.seed, 6)
    pool = gen.capacities(gen.rng(tr["pool_seed"], 6), tr["pool"], d,
                          cfg["caps"])
    order = draws.permutation(tr["pool"])
    count = [0]

    def draw():
        failed = int(draws.integers(n))
        survivors = [i for i in range(n) if i != failed]
        providers = [int(x) for x in draws.choice(survivors, d,
                                                  replace=False)]
        caps = pool[order[count[0] % len(order)]][None]
        count[0] += 1
        return failed, providers, caps

    profile = PlannerProfile() if ctx.trace else None
    drawn, plans = [], []

    def repair(timed: bool):
        failed, providers, caps = draw()
        sim.nodes[failed].payload.zero_()          # the node's data is lost
        ctx.sync()
        t0 = now()
        with span("repair.plan"):
            res = core.plan_many(caps, params, scheme, device=dev,
                                 profile=profile if timed else None)
            [pl] = core.plans_from_batch(res, params)
        with span("repair.execute"):
            sim.execute_plan(pl, failed, providers)
            ctx.sync()
        if timed:
            rec.samples["repair_s"].append(now() - t0)
            drawn.append(caps[0])
            plans.append(pl)

    for _ in range(WARM_REPAIRS):
        repair(False)

    products.on = ctx.trace
    traced = None
    ctx.open_window()
    while ctx.window_left() > 0:
        if ctx.trace and len(plans) == tr["traced_after"]:
            traced = device_trace(ctx, "repair")
            traced.__enter__()
        rec.attempted += 1
        try:
            repair(True)
        except Exception as exc:           # a repair that never comes
            rec.failed += 1
            rec.errors.append(repr(exc))
        if traced is not None and rec.trace is None and \
                len(plans) == tr["traced_after"] + tr["traced_repairs"]:
            traced.__exit__(None, None, None)
    if traced is not None and rec.trace is None:
        traced.__exit__(None, None, None)
    ctx.sync()
    rec.values["window_s"] = now() - ctx.window_start
    rec.values["repairs"] = len(plans)
    if profile is not None:
        stages = profile.summary()["stages"]
        if "total" in stages and stages["total"]["calls"]:
            rec.values["plan_total_ms"] = (stages["total"]["ms"]
                                           / stages["total"]["calls"])
    rec.samples["gf_products"] = products.readings()
    rec.notes.append(f"repairs {len(plans)}, overlays planned twice "
                     f"{max(0, count[0] - len(order))}")
    if dev.type == "cuda":
        rec.values["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    # -- the judge ------------------------------------------------------------
    t0 = now()
    jr = gen.rng(ctx.seed, 7)
    picks = jr.choice(len(plans), min(len(plans), cfg["judge"]["plans"]),
                      replace=False) if plans else []
    judge_plans(rec, drawn, plans, code, scheme, limits, picks)
    cols = gen.sample_columns(jr, cfg["block_bytes"],
                              cfg["judge"]["columns"])
    held = [sim.nodes[i] for i in range(n)]
    vectors = torch.cat([b.vectors for b in held]).cpu()
    payload_cols = coded.gather_columns([b.payload for b in held], cols)
    data_cols = coded.gather_columns([file_blocks], cols)
    del held, sim, nodes, rl
    rec.check("wrong_bytes", coded.wrong_bytes(vectors, payload_cols,
                                               data_cols),
              limits["wrong_bytes"])
    rec.values["reference_s"] = now() - t0
    return rec
