"""Quickstart: the paper's Fig. 1 worked example, end to end (the
counterpart of ``examples/quickstart.py``).

Builds the 4-provider overlay (70/50/20/10 Mbps direct links, a 35 Mbps
v4->v1 side link), plans a regeneration of the failed node with the four
paper schemes (plus the MDS-breaking RCTREE baseline) through the unified
planner API (``repro_torch.core.plan``), verifies the MDS property of each
plan via the information-flow graph, plans a small Monte-Carlo batch with
``plan_many`` on the planning tier across the pinned batched family, and
executes the FTR plan on real GF(2^8)-coded data.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The batch and the coded data live on the card unless ``--device cpu`` is
given; the scalar planners run on the host.
"""
from __future__ import annotations

import argparse
import math
import random
from typing import Any, Dict

import numpy as np
import torch

from .coding import GF8, RLNC
from .core import (CodeParams, InfoFlowGraph, OverlayNetwork, caps_tensor,
                   event_from_plan, plan, plan_many, scheme_names)
from .device import resolve_device

# plan_many plans a whole batch of sampled overlays in one call per scheme.
# The family is pinned here (not enumerated from the registry) so that a
# scheme losing its batched planner fails loudly.
BATCHED_FAMILY = ("star", "fr", "tr", "ftr", "shah")


def fig1():
    """Fig. 1: n=5, k=2, d=4, M=480 Mb, alpha=240, beta=80, and its
    overlay."""
    P = CodeParams.msr(n=5, k=2, d=4, M=480.0)
    net = OverlayNetwork.star_only([70.0, 50.0, 20.0, 10.0], cross=5.0)
    net.cap[4][1] = 35.0
    return P, net


def main(argv=None) -> Dict[str, Any]:
    """Runs the example, printing as the reference's script does; returns
    the plans, the batch's mean times and whether the file came back."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: Dict[str, Any] = {"plans": {}, "batch_means": {}}

    P, net = fig1()
    print(f"(n={P.n}, k={P.k}) MDS code, d={P.d} providers, "
          f"M={P.M:.0f} Mb, alpha={P.alpha:.0f} Mb, beta={P.beta:.0f} Mb\n")

    print(f"{'scheme':8s} {'time (s)':>9s} {'traffic (Mb)':>13s}  tree")
    for scheme in ("star", "fr", "tr", "ftr"):
        p = plan(net, P, scheme)
        p.validate(net)
        out["plans"][scheme] = p
        tree = " ".join(f"v{u}->v{pa}" if pa else f"v{u}->nc"
                        for u, pa in sorted(p.parent.items()))
        print(f"{p.scheme:8s} {p.time:9.3f} {p.total_traffic:13.1f}  {tree}")

        # MDS check: fail node 5, repair, then every k-subset must reach M
        g = InfoFlowGraph(P, initial_nodes=[1, 2, 3, 4, 5])
        g.fail_and_repair(5, event_from_plan(p, 6, [1, 2, 3, 4]))
        worst, flow = g.worst_collector()
        if flow < P.M - 1e-6:
            raise AssertionError((p.scheme, worst, flow))
    print("\nall four schemes preserve the MDS property (min-cut >= M)")

    bad = plan(net, P, "rctree")
    out["plans"]["rctree"] = bad
    g = InfoFlowGraph(P, initial_nodes=[1, 2, 3, 4, 5])
    g.fail_and_repair(5, event_from_plan(bad, 6, [1, 2, 3, 4]))
    worst, flow = g.worst_collector()
    out["rctree_min_cut"] = flow
    print(f"RCTREE [7] min-cut through {worst} = {flow:.0f} Mb < M={P.M:.0f} "
          f"-> MDS broken (Appendix A)\n")

    # --- Monte-Carlo batch through the planning tier ------------------------
    if not set(BATCHED_FAMILY) <= set(scheme_names()):
        raise AssertionError("registry lost a scheme")
    rng = random.Random(0)
    batch = [OverlayNetwork([[0.0 if u == v else rng.uniform(10.0, 120.0)
                              for v in range(P.d + 1)]
                             for u in range(P.d + 1)])
             for _ in range(16)]
    caps = caps_tensor(batch, dev)
    print("mean regeneration time over a 16-overlay Monte-Carlo batch "
          "(engine='batched'):")
    for scheme in BATCHED_FAMILY:
        res = plan_many(caps, P, scheme, engine="batched", device=dev)
        if res.engine != "batched":
            raise AssertionError(f"{scheme} silently took the {res.engine} "
                                 f"path")
        mean = float(res.times.mean())
        out["batch_means"][scheme] = mean
        print(f"  {scheme:6s} {mean:7.3f} s   [{res.engine} engine]")
    print()

    # --- execute the FTR plan on real coded blocks --------------------------
    print("executing the FTR plan on real GF(2^8)-coded blocks...")
    nrng = np.random.default_rng(0)
    rl = RLNC(GF8, device=dev)
    M_blocks, blk = 8, 64                       # 8 blocks of 64 bytes
    alpha_b = M_blocks // P.k                   # 4 blocks/node
    file_blocks = rl.random((M_blocks, blk), nrng)
    nodes = dict(enumerate(rl.distribute(file_blocks, P.n, alpha_b, nrng), 1))

    ftr_plan = plan(net, P, "ftr")
    scalefactor = alpha_b / P.alpha             # paper Mb -> demo blocks
    children: Dict[int, list] = {}
    for u, pa in ftr_plan.parent.items():
        children.setdefault(pa, []).append(u)

    def produce(u):     # bottom-up along the tree
        own = rl.encode(nodes[u], math.ceil(
            ftr_plan.betas[u - 1] * scalefactor - 1e-9), nrng)
        recv = None
        for ch in children.get(u, []):
            part = produce(ch)
            recv = part if recv is None else recv.concat(part)
        if recv is None:
            return own
        quota = math.ceil(ftr_plan.flows[(u, ftr_plan.parent[u])]
                          * scalefactor - 1e-9)
        return rl.relay(recv, own, quota, nrng)

    received = None
    for r in children.get(0, []):
        part = produce(r)
        received = part if received is None else received.concat(part)
    newcomer = rl.regenerate(received, alpha_b, nrng)
    ok = rl.can_reconstruct([newcomer, nodes[3]], M_blocks)
    got = rl.reconstruct([newcomer, nodes[3]], M_blocks)
    if not (ok and torch.equal(got, file_blocks)):
        raise AssertionError("the newcomer and v3 do not give back the file")
    out["file_restored"] = True
    print("newcomer + v3 reconstruct the original file: OK")
    return out


if __name__ == "__main__":
    main()
