"""Repair-round simulation (paper Section VI + Appendix A Fig. 10).

Two levels of fidelity, as in ``repro.storage.simulator``:

* ``compare_schemes`` — planning-level Monte Carlo: per round, sample an
  overlay, plan with each scheme, record regeneration time and total repair
  traffic normalized against STAR on the *same* network (Figs 6-8).
  The batched engine plans every trial in one call on the card.
* ``RlncSimulator`` — data-plane simulation with real GF(2^8) coding
  vectors and payload, held on the card: executes plans block by block
  (provider encode, interior relay, newcomer regenerate) through the GF
  matmul kernel, and measures the probability that k random nodes can
  still reconstruct the file (Fig. 10, RCTREE's MDS collapse).

Every random draw is the reference's, from the same streams in the same
order, so from one seed the node states are equal to the reference's bit
for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..coding import GF, GF8, RLNC, CodedBlocks
from ..coding.rlnc import Matmul
from ..core import (CodeParams, RepairPlan, caps_tensor, get_scheme, plan,
                    plan_many, plans_from_batch)
from ..device import DeviceLike
from .capacities import CapSampler


# ---------------------------------------------------------------------------
# Planning-level Monte Carlo (Figs 6-8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchemeStats:
    scheme: str
    mean_time: float
    mean_norm_time: float      # vs STAR on the same sampled network
    mean_traffic: float
    mean_norm_traffic: float
    plan_seconds: float        # mean planner wall time
    engine: str = "scalar"     # engine that actually planned this scheme


def compare_schemes(params: CodeParams, sampler: CapSampler,
                    schemes: Sequence[str], trials: int, seed: int = 0,
                    engine: str = "batched", witness: str = "exact",
                    device: DeviceLike = None) -> Dict[str, SchemeStats]:
    """Monte-Carlo scheme comparison over ``trials`` sampled overlays.

    ``engine="batched"`` (default) plans every trial of a scheme in one
    :func:`~repro_torch.core.plan_many` call on ``device`` (the card unless
    ``device="cpu"``), the STAR baseline on the same engine; a scheme
    without a batched planner (rctree) takes the scalar planner, with the
    registry's warning, and says so in ``SchemeStats.engine``.
    ``engine="scalar"`` is the per-network loop.  ``plan_seconds`` is wall
    time per trial, ending when the device's work is done.
    """
    if engine not in ("batched", "scalar"):
        raise ValueError(f"unknown engine {engine!r}")
    rng = random.Random(seed)
    nets = [sampler(rng, params.d) for _ in range(trials)]
    if engine == "batched":
        caps = caps_tensor(nets, device)
        base = plan_many(caps, params, "star", engine=engine,
                         device=caps.device)
        out: Dict[str, SchemeStats] = {}
        for s in schemes:
            t0 = time.perf_counter()
            res = plan_many(caps, params, s, engine=engine, witness=witness,
                            device=caps.device)
            times, traffic = res.times.to(caps.device), \
                res.traffic.to(caps.device)
            stats = torch.stack([times.mean(), (times / base.times).mean(),
                                 traffic.mean(),
                                 (traffic / base.traffic).mean()]).tolist()
            dt = time.perf_counter() - t0
            out[s] = SchemeStats(s, *stats, dt / trials, engine=res.engine)
        return out
    acc = {s: [0.0, 0.0, 0.0, 0.0, 0.0] for s in schemes}
    for net in nets:
        base = plan(net, params, "star", engine="scalar")
        for s in schemes:
            t0 = time.perf_counter()
            p = plan(net, params, s, engine="scalar", witness=witness)
            dt = time.perf_counter() - t0
            a = acc[s]
            a[0] += p.time
            a[1] += p.time / base.time
            a[2] += p.total_traffic
            a[3] += p.total_traffic / base.total_traffic
            a[4] += dt
    return {
        s: SchemeStats(s, a[0] / trials, a[1] / trials, a[2] / trials,
                       a[3] / trials, a[4] / trials)
        for s, a in acc.items()
    }


# ---------------------------------------------------------------------------
# Data-plane simulation with real coding vectors (Fig. 10)
# ---------------------------------------------------------------------------

class RlncSimulator:
    """Distributed storage system with actual RLNC state per node, on one
    device (the card unless ``device="cpu"``).  ``engine="batched"``
    (default) plans on that device through the planning tier;
    ``engine="scalar"`` plans with the scalar planners on the host."""

    def __init__(self, params: CodeParams, field: GF = GF8,
                 block_bytes: int = 4, seed: int = 0,
                 matmul: Optional[Matmul] = None, device: DeviceLike = None,
                 engine: str = "batched"):
        self._setup(params, field, matmul, device, engine)
        self.np_rng = np.random.default_rng(seed)
        self.rng = random.Random(seed + 1)
        M, n, alpha = int(params.M), params.n, int(round(params.alpha))
        self.file_blocks = self.rl.random((M, block_bytes), self.np_rng)
        self.nodes: Dict[int, CodedBlocks] = dict(
            enumerate(self.rl.distribute(self.file_blocks, n, alpha,
                                         self.np_rng)))

    def _setup(self, params: CodeParams, field: GF, matmul: Optional[Matmul],
               device: DeviceLike, engine: str) -> None:
        if abs(params.M - round(params.M)) > 1e-9 or \
           abs(params.alpha - round(params.alpha)) > 1e-9:
            raise ValueError("data-plane simulation needs integral M, alpha")
        if engine not in ("batched", "scalar"):
            raise ValueError(f"unknown engine {engine!r}")
        self.params = params
        self.engine = engine
        self.field = field
        self.rl = RLNC(field, matmul=matmul, device=device)
        self.device = self.rl.device

    @classmethod
    def from_state(cls, params: CodeParams, file_blocks,
                   nodes: Dict[int, CodedBlocks],
                   np_rng: np.random.Generator, rng: random.Random,
                   field: GF = GF8, matmul: Optional[Matmul] = None,
                   device: DeviceLike = None,
                   engine: str = "batched") -> "RlncSimulator":
        """A simulator over given state: the file, the nodes' blocks and the
        two random streams (see ``storage.convert``)."""
        sim = cls.__new__(cls)
        sim._setup(params, field, matmul, device, engine)
        sim.np_rng = np_rng
        sim.rng = rng
        sim.file_blocks = file_blocks
        sim.nodes = dict(nodes)
        return sim

    def execute_plan(self, plan: RepairPlan, failed: int,
                     provider_ids: Sequence[int]) -> None:
        """Replace ``failed`` by running ``plan`` on the real coded state.

        Fractional betas/flows are ceil-rounded (Section III-C).  For the
        broken RCTREE baseline, flows are the plan's fixed per-edge beta,
        which is what destroys information at interior nodes.
        """
        alpha = int(round(self.params.alpha))
        idmap = {i: pid for i, pid in enumerate(provider_ids, start=1)}
        children: Dict[int, List[int]] = {}
        for u, p in plan.parent.items():
            children.setdefault(p, []).append(u)

        def produce(u: int) -> CodedBlocks:
            """Blocks node u sends to its tree parent."""
            own_quota = plan.betas[u - 1]
            recv: Optional[CodedBlocks] = None
            for ch in children.get(u, []):
                part = produce(ch)
                recv = part if recv is None else recv.concat(part)
            send_quota = int(math.ceil(plan.flows[(u, plan.parent[u])] - 1e-9))
            own = self.rl.encode(self.nodes[idmap[u]],
                                 int(math.ceil(own_quota - 1e-9)), self.np_rng)
            if recv is None:
                out = own
            else:
                pool = recv.concat(own)
                if pool.num > send_quota:
                    out = self.rl.relay(recv, own, send_quota, self.np_rng)
                else:
                    out = pool
            # cap at the plan's edge flow (RCTREE keeps this below alpha)
            if out.num > send_quota:
                out = CodedBlocks(out.vectors[:send_quota],
                                  out.payload[:send_quota])
            return out

        received: Optional[CodedBlocks] = None
        for r in children.get(0, []):
            part = produce(r)
            received = part if received is None else received.concat(part)
        if received is None:
            raise ValueError("plan has no provider attached to the newcomer")
        self.nodes[failed] = self.rl.regenerate(received, alpha, self.np_rng)

    def _sample_round(self, sampler: CapSampler,
                      failed: Optional[int] = None):
        """(failed, providers, overlay) for one repair round.

        Draws only from ``self.rng``; the data-plane ``np_rng`` is a
        separate stream."""
        ids = sorted(self.nodes)
        if failed is None:
            failed = self.rng.choice(ids)
        survivors = [i for i in ids if i != failed]
        providers = self.rng.sample(survivors, self.params.d)
        net = sampler(self.rng, self.params.d)
        return failed, providers, net

    def plan_rounds(self, scheme: str, sampler: CapSampler,
                    rounds: int) -> List:
        """Pre-sample ``rounds`` repair rounds and plan them all.

        Plans depend only on the sampled overlays, never on the coded
        state, so this equals planning round by round as long as nothing
        else draws from ``self.rng`` in between.  Returns
        [(failed, providers, plan), ...] ready for ``execute_plan``.
        """
        drawn = [self._sample_round(sampler) for _ in range(rounds)]
        plans = self._plan([net for _, _, net in drawn], scheme)
        return [(f, p, pl) for (f, p, _), pl in zip(drawn, plans)]

    def repair_round(self, scheme: str, sampler: CapSampler,
                     failed: Optional[int] = None) -> RepairPlan:
        failed, providers, net = self._sample_round(sampler, failed)
        [pl] = self._plan([net], scheme)
        self.execute_plan(pl, failed, providers)
        return pl

    def _plan(self, nets: list, scheme: str) -> List[RepairPlan]:
        """One plan per overlay, planned in one call: on the simulator's
        device by the batched engine where the scheme has one (rctree takes
        the scalar planner), on the host by the scalar engine."""
        eng = "auto" if self.engine == "batched" else "scalar"
        res = plan_many(nets, self.params, scheme, engine=eng,
                        device=self.device)
        return plans_from_batch(res, self.params)

    def reconstruction_probability(self, samples: int = 0) -> float:
        """Fraction of k-subsets (all, or ``samples`` random ones) whose
        combined coding vectors have rank >= M."""
        ids = sorted(self.nodes)
        k, M = self.params.k, int(self.params.M)
        combos = list(itertools.combinations(ids, k))
        if samples and samples < len(combos):
            combos = self.rng.sample(combos, samples)
        ok = 0
        for combo in combos:
            if self.rl.can_reconstruct([self.nodes[i] for i in combo], M):
                ok += 1
        return ok / len(combos)


def reconstruction_vs_rounds(params: CodeParams, scheme: str,
                             sampler: CapSampler, rounds: int, trials: int,
                             field: GF = GF8, seed: int = 0,
                             subset_samples: int = 0,
                             engine: str = "batched",
                             device: DeviceLike = None) -> List[float]:
    """Fig. 10: mean reconstruction probability after each repair round.

    With the batched engine each trial's rounds are drawn first and planned
    in one call: a plan depends only on its overlay, and the overlay stream
    is not the data plane's, so the node states equal those of planning
    round by round.  That holds only while nothing else draws from
    ``sim.rng`` between rounds, so with ``subset_samples > 0`` (the subset
    draws come from that stream), and for schemes without a batched planner
    (rctree), the rounds are planned one by one."""
    probs = [0.0] * (rounds + 1)
    for tr in range(trials):
        sim = RlncSimulator(params, field=field, seed=seed + 1000 * tr,
                            device=device, engine=engine)
        probs[0] += sim.reconstruction_probability(subset_samples)
        if (engine == "batched" and subset_samples == 0
                and get_scheme(scheme).batched is not None):
            planned = sim.plan_rounds(scheme, sampler, rounds)
            for r, (failed, providers, pl) in enumerate(planned, start=1):
                sim.execute_plan(pl, failed, providers)
                probs[r] += sim.reconstruction_probability(subset_samples)
        else:
            for r in range(1, rounds + 1):
                sim.repair_round(scheme, sampler)
                probs[r] += sim.reconstruction_probability(subset_samples)
    return [p / trials for p in probs]
