"""Failure -> regeneration plan (the paper's algorithms as the repair
engine): the counterpart of ``repro.ft.planner``.

``plan_recovery`` snapshots the available bandwidth between the replacement
host and the d chosen providers, runs the requested scheme(s) and returns
the best plan with its predicted regeneration time.  ``auto`` evaluates
star/FR/TR/FTR and picks the fastest.  A straggler is a provider with low
available bandwidth, so FR shifts traffic off it and TR/FTR route around
it (paper Sections III-V).

The planners are the scalar ones on the host, as in the reference: one
overlay per failure, where the planning tier on the card loses to the host
(a batch of one).  The draws come from the same ``random.Random`` stream,
so providers, overlays and plans equal the reference's.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

from ..core import (CodeParams, OverlayNetwork, RepairPlan, plan_fr,
                    plan_ftr, plan_star, plan_tr)
from .topology import Fleet

_PLANNERS = {"star": plan_star, "fr": plan_fr, "tr": plan_tr, "ftr": plan_ftr}


@dataclasses.dataclass
class RecoveryDecision:
    newcomer: int
    providers: List[int]
    overlay: OverlayNetwork
    plan: RepairPlan
    predicted_s: float
    alternatives: Dict[str, float]      # scheme -> predicted time


def choose_providers(fleet: Fleet, survivors: Sequence[int], newcomer: int,
                     d: int, rng: Optional[random.Random] = None,
                     prefer_local: bool = True) -> List[int]:
    """Pick d providers; prefer same-pod hosts (fast tier) when available."""
    rng = rng or fleet.rng
    pool = sorted(survivors)
    if not prefer_local:
        return rng.sample(pool, d)
    local = [h for h in pool if fleet.pod_of(h) == fleet.pod_of(newcomer)]
    remote = [h for h in pool if h not in local]
    rng.shuffle(local)
    rng.shuffle(remote)
    picked = (local + remote)[:d]
    return sorted(picked)


def plan_recovery(fleet: Fleet, params: CodeParams, newcomer: int,
                  providers: Sequence[int], block_mb: float = 1.0,
                  scheme: str = "auto",
                  rng: Optional[random.Random] = None) -> RecoveryDecision:
    overlay = fleet.snapshot_overlay(newcomer, providers, block_mb=block_mb,
                                     rng=rng)
    alts: Dict[str, float] = {}
    best_plan = None
    names = list(_PLANNERS) if scheme == "auto" else [scheme]
    for name in names:
        plan = _PLANNERS[name](overlay, params)
        alts[name] = plan.time
        if best_plan is None or plan.time < best_plan.time:
            best_plan = plan
    return RecoveryDecision(newcomer=newcomer, providers=list(providers),
                            overlay=overlay, plan=best_plan,
                            predicted_s=best_plan.time, alternatives=alts)
