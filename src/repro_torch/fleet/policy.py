"""Pluggable repair policies: which scheme plans each regeneration.

A policy receives the residual-capacity overlays of *every* repair starting
at the current event epoch as one ``(R, d+1, d+1)`` tensor and returns one
:class:`RepairPlan` per repair.  This batch-shaped interface is what lets
the batched planning engine serve as the decision core: a fixed policy
plans all R repairs with one ``repro_torch.core.plan_many`` call, and the
flexible policy plans all R repairs under *every* candidate scheme (one
batched call per scheme) and picks, per repair, the fastest plan under the
residual capacities — the fleet-scale version of the paper's "choose the
scheme that minimizes regeneration time" message.  Scheme names are
validated against the scheme registry (``repro_torch.core.api``), so a policy
spec for a newly registered scheme works with no fleet-side change.

The residual overlays are a *same-epoch snapshot*: repairs admitted at one
event epoch are planned against the shares left by already-active work,
not against each other (planning them jointly would serialize the batch).
Once they start, the fair-share model charges them for each other anyway,
so a same-epoch batch that collides on a link runs slower than its plans
predicted — the simulator's contention signal, not a planning error.

Custom policies only need ``plan_batch``, so anything from an RL agent to
an LP-based global scheduler can plug in.

Device: the simulator passes its device (``device=``, the card unless the
caller named the CPU) to every call.  The built-in policies plan on it
through the port's ``plan_many``: the overlay batch crosses to the device
once per call, every batched scheme plans there, and all the schemes'
plans come back to the host in one copy (``plans_from_batches``).  Schemes
without a batched planner (rctree), and ``engine="scalar"``, plan on the
host with the scalar planners.

The interface has a second batched entry point:
:meth:`RepairPolicy.replan` proposes replacement plans for in-flight
repairs at capacity-shock / provider-loss epochs (plan migration).  The
default delegates to ``plan_batch`` — the flexible policy thereby migrates
a repair to whatever scheme/tree is fastest under the *current* shares,
and a fixed policy re-treeifies within its scheme — while the simulator
applies banked-work credit and keeps the migration only if it wins.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (CodeParams, RepairPlan, get_scheme, plan_many,
                    plans_from_batches)
from ..core.api import ENGINES
from ..device import DeviceLike, resolve_device


class RepairPolicy:
    """Interface: plan a batch of repairs under residual capacities."""

    name = "abstract"

    def plan_batch(self, caps: np.ndarray, params: CodeParams,
                   device: DeviceLike = None) -> List[RepairPlan]:
        raise NotImplementedError

    def replan(self, caps: np.ndarray, params: CodeParams,
               device: DeviceLike = None) -> List[Optional[RepairPlan]]:
        """Propose replacement plans for *in-flight* repairs.

        Called by the simulator at capacity-shock and provider-loss epochs
        when ``Scenario.migration`` is on, and — single-row — by the
        watchdog's rescue step when a flagged repair's first mitigation
        attempt replans it in place (``Scenario.watchdog_period`` > 0,
        see ``sim.FleetSimulator._watchdog_replan``).  Either way the
        input is one ``(R, d+1, d+1)`` tensor of *self-excluded* residual
        overlays — each in-flight
        repair's own link occupancy is discounted, so row r is the share
        snapshot that repair would plan under if it released its current
        links.  Return one plan (or ``None`` to decline) per row, same
        batched one-call-per-epoch contract as :meth:`plan_batch`.

        The simulator — not the policy — owns the accept decision: it
        subtracts the repair's banked blocks from the proposal's edge
        demands (credit transfer) and migrates only if the credited ETA
        beats the current one.  The default proposes exactly what
        :meth:`plan_batch` would plan, which gives every policy tree/
        scheme adaptation for free; override to decline or customize.
        """
        return self.plan_batch(caps, params, device=device)

    def replan_candidates(self, caps: np.ndarray, params: CodeParams,
                          device: DeviceLike = None,
                          ) -> List[List[Optional[RepairPlan]]]:
        """All replacement-plan candidates per in-flight repair, for
        bank-aware migration (``Scenario.bank_aware_migration``).

        Where :meth:`replan` pre-picks one proposal per repair — by
        nominal time, blind to banked work — this returns the full slate
        so the *simulator* can score each candidate by credited residual
        ETA and prefer trees overlapping already-received blocks.  The
        default slate is the single :meth:`replan` proposal; policies
        with a real scheme race override it.
        """
        return [[p] for p in self.replan(caps, params, device=device)]


def _engine_for(scheme: str, engine: str) -> str:
    """Per-scheme engine for a policy-level preference.

    ``"auto"``, ``"batched"`` and ``"scalar"`` mean what they mean to
    ``plan_many``, except that ``"batched"`` on a scheme without a batched
    planner (rctree) is resolved here, silently, to ``"scalar"``: the policy
    knows about that downgrade and passes ``plan_many`` an exact request.
    The reference's ``"jax"`` tier has no counterpart in the port: its work
    is the ``"batched"`` engine's.
    """
    if engine == "jax":
        raise ValueError("engine='jax' is the reference's accelerator tier; "
                         "the port's vectorized engine is 'batched'")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine == "batched" and get_scheme(scheme).batched is None:
        engine = "scalar"
    return engine


def _plan_schemes(caps: np.ndarray, params: CodeParams,
                  schemes: Sequence[Tuple[str, str]], device: DeviceLike,
                  ) -> List[List[RepairPlan]]:
    """Plan ``caps`` under each (scheme, engine), as resolved by
    :func:`_engine_for`: one copy of the batch to the device, one copy of
    all the schemes' plans back."""
    dev_caps = None
    results = []
    for scheme, engine in schemes:
        nets = caps
        if engine != "scalar" and get_scheme(scheme).batched is not None:
            if dev_caps is None:
                dev_caps = torch.from_numpy(
                    np.asarray(caps, dtype=np.float64)).to(
                        resolve_device(device))
            nets = dev_caps
        results.append(plan_many(nets, params, scheme, engine=engine,
                                 device=device))
    return plans_from_batches(results, params)


class FixedPolicy(RepairPolicy):
    """Always the same scheme (any name in the scheme registry).

    Planning goes through :func:`repro_torch.core.plan_many` with
    ``engine="auto"`` by default: schemes registered with a batched
    planner plan on the simulator's device, schemes declared scalar-only
    (rctree) take the per-overlay scalar planner on the host — the
    registry owns that decision, not this class.
    """

    def __init__(self, scheme: str, engine: str = "auto"):
        self.spec = get_scheme(scheme)   # raises listing registered schemes
        self.scheme = scheme
        self.name = scheme
        self.engine = engine
        self._engine = _engine_for(scheme, engine)

    def plan_batch(self, caps: np.ndarray, params: CodeParams,
                   device: DeviceLike = None) -> List[RepairPlan]:
        [plans] = _plan_schemes(caps, params, [(self.scheme, self._engine)],
                                device)
        return plans


class FlexiblePolicy(RepairPolicy):
    """Plan every candidate scheme in one batched call each; per repair,
    keep the plan with the smallest regeneration time under the residual
    capacities.  Ties break toward the earlier scheme in ``schemes`` (the
    default order prefers ftr), keeping the choice deterministic.

    Engines are mixed per scheme: the policy-level ``engine`` preference
    is resolved scheme by scheme (see :func:`_engine_for`), so schemes
    with a batched planner plan on the device in one call each while
    scalar-only schemes (rctree) loop the scalar oracle on the host.
    """

    name = "flexible"

    def __init__(self, schemes: Sequence[str] = ("ftr", "tr", "fr", "star"),
                 engine: str = "auto"):
        for s in schemes:
            get_scheme(s)                # raises listing registered schemes
        self.schemes: Tuple[str, ...] = tuple(schemes)
        self.engine = engine
        self._engines = [(s, _engine_for(s, engine)) for s in self.schemes]

    def plan_batch(self, caps: np.ndarray, params: CodeParams,
                   device: DeviceLike = None) -> List[RepairPlan]:
        per_scheme = _plan_schemes(caps, params, self._engines, device)
        times = np.array([[p.time for p in plans] for plans in per_scheme])
        winner = np.argmin(times, axis=0)       # first minimum wins ties
        return [per_scheme[int(winner[r])][r] for r in range(caps.shape[0])]

    def replan_candidates(self, caps: np.ndarray, params: CodeParams,
                          device: DeviceLike = None,
                          ) -> List[List[Optional[RepairPlan]]]:
        """One candidate per scheme per repair, in scheme-preference order
        (so bank-aware scoring ties break toward the earlier scheme,
        matching :meth:`plan_batch`'s determinism)."""
        per_scheme = _plan_schemes(caps, params, self._engines, device)
        return [[plans[r] for plans in per_scheme]
                for r in range(caps.shape[0])]


def make_policy(spec: str, engine: str = "auto") -> RepairPolicy:
    """'flexible' or a fixed scheme name — the CLI/bench entry point.

    ``engine`` is the policy-level preference ("auto" | "scalar" |
    "batched"), resolved per scheme by :func:`_engine_for`.
    """
    if spec == "flexible":
        return FlexiblePolicy(engine=engine)
    return FixedPolicy(spec, engine=engine)
