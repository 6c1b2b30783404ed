"""Planner API: the scheme registry behind ``plan()`` / ``plan_many()``.

The counterpart of ``repro.core.api``.  Each scheme is one
:class:`SchemeSpec`: its scalar planner (host code), its batched planner in
:mod:`.torch_engine` (or ``None``, as for rctree), and whether the planners
take the ``witness=`` selector or the ``profile=`` hook.

Engines (``ENGINES``): ``"scalar"`` runs the per-network planners on the
host; ``"batched"`` runs the tensor programs of :mod:`.torch_engine` on one
device; ``"auto"`` is the scalar planner for :func:`plan` and the batched
planner, where the scheme has one, for :func:`plan_many`.  A scheme
without a batched planner asked for ``"batched"`` warns once per scheme
and takes the scalar planner.  The reference's ``"jax"`` tier has no
counterpart here: its work is the ``"batched"`` engine's.

Devices: the batched engine runs on the card unless ``device="cpu"`` is
passed; a CUDA capacity tensor plans on its own device.  There is no
fallback: without CUDA and without ``device="cpu"`` it raises
``RuntimeError``.  The scalar engine needs no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import spans
from .batched import BatchPlanResult, caps_tensor, plans_from_batch
from .params import CodeParams, OverlayNetwork, RepairPlan
from .star import plan_fr, plan_shah, plan_star
from .tree import plan_tr
from .ftr import plan_ftr
from .rctree import plan_rctree
from . import torch_engine

__all__ = ["ENGINES", "SchemeSpec", "get_scheme", "plan", "plan_many",
           "register_scheme", "scheme_names"]

ScalarPlanner = Callable[..., RepairPlan]
BatchedPlanner = Callable[..., BatchPlanResult]
ENGINES = ("auto", "scalar", "batched")
Nets = Union[np.ndarray, torch.Tensor, Sequence[OverlayNetwork]]


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One registered regeneration scheme: its scalar planner ``(net,
    params, **kw) -> RepairPlan``, its batched planner ``(caps, params,
    **kw) -> BatchPlanResult`` or ``None``, whether the planners take the
    ``witness=`` selector, and whether the batched planner takes the
    ``profile=`` hook."""

    name: str
    scalar: ScalarPlanner
    batched: Optional[BatchedPlanner] = None
    accepts_witness: bool = False
    accepts_profile: bool = False


_REGISTRY: Dict[str, SchemeSpec] = {}


def register_scheme(name: str, scalar: Optional[ScalarPlanner] = None, *,
                    batched: Optional[BatchedPlanner] = None,
                    accepts_witness: bool = False,
                    accepts_profile: bool = False):
    """Register a scheme; usable directly (returns the :class:`SchemeSpec`)
    or as a decorator (returns the planner unchanged).  Registering a name
    twice raises."""
    def _register(fn: ScalarPlanner) -> SchemeSpec:
        if name in _REGISTRY:
            raise ValueError(f"scheme {name!r} is already registered")
        spec = SchemeSpec(name=name, scalar=fn, batched=batched,
                          accepts_witness=accepts_witness,
                          accepts_profile=accepts_profile)
        _REGISTRY[name] = spec
        return spec

    if scalar is None:
        def _decorator(fn: ScalarPlanner) -> ScalarPlanner:
            _register(fn)
            return fn
        return _decorator
    return _register(scalar)


def get_scheme(name: str) -> SchemeSpec:
    """Resolve a scheme name, with an error that lists what is registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}; registered schemes: "
                         f"{sorted(_REGISTRY)}") from None


def scheme_names() -> Tuple[str, ...]:
    """Registered scheme names in registration order."""
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Engine resolution
# ---------------------------------------------------------------------------

_warned_scalar_fallback: set = set()


def _check_engine(engine: str) -> None:
    if engine == "jax":
        raise ValueError("engine='jax' is the reference's accelerator tier; "
                         "the port's vectorized engine is 'batched'")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def _resolve_engine(spec: SchemeSpec, engine: str, entry: str) -> str:
    """``"auto"`` takes the batched planner where there is one; an explicit
    ``"batched"`` on a scheme without one warns once per scheme and takes
    the scalar planner."""
    if engine == "batched" and spec.batched is None:
        if spec.name not in _warned_scalar_fallback:
            _warned_scalar_fallback.add(spec.name)
            warnings.warn(
                f"{entry}(engine='batched'): no batched planner registered "
                f"for {spec.name!r}; falling back to the scalar planner for "
                f"all networks", RuntimeWarning, stacklevel=3)
        return "scalar"
    if engine == "auto":
        return "batched" if spec.batched is not None else "scalar"
    return engine


def _planner_kwargs(spec: SchemeSpec, witness: str, kwargs: dict) -> dict:
    """``witness`` reaches exactly the schemes that declared it; other
    keyword arguments pass through to the planner."""
    kw = dict(kwargs)
    if spec.accepts_witness:
        kw["witness"] = witness
    return kw


@contextlib.contextmanager
def _total(profile, device: Optional[torch.device]):
    """The ``profile=`` hook's ``"total"`` stage (any object with the
    ``stage``/``note`` contract of the reference's ``PlannerProfile``),
    ending with the device's work done.  Without a profile, nothing."""
    if profile is None:
        yield
        return
    with profile.stage("total"):
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)


def _caps_on_device(nets: Nets, device: DeviceLike) -> torch.Tensor:
    """The batch's capacities as a float64 tensor on the planning device: a
    CUDA tensor stays where it is unless ``device`` names another."""
    if isinstance(nets, torch.Tensor):
        dev = (nets.device if device is None and nets.is_cuda
               else resolve_device(device))
        return nets.to(device=dev, dtype=torch.float64)
    if isinstance(nets, np.ndarray):
        return torch.from_numpy(np.asarray(nets, dtype=np.float64)).to(
            resolve_device(device))
    return caps_tensor(nets, device)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def plan(net: OverlayNetwork, params: CodeParams, scheme: str,
         engine: str = "auto", witness: str = "exact", profile=None,
         device: DeviceLike = None, **kwargs) -> RepairPlan:
    """Plan one regeneration of ``net`` with ``scheme``.

    ``engine="auto"`` (default) and ``"scalar"`` run the scalar planner;
    ``"batched"`` plans a batch of one on ``device`` and materializes its
    plan.  ``profile`` notes the call and times it (fr and ftr on the
    batched engine also time their stages); extra keyword arguments
    (``beta_max=`` for shah, ``region=`` for fr/ftr) reach the planner.
    """
    _check_engine(engine)
    spec = get_scheme(scheme)
    resolved = "scalar" if engine == "auto" else \
        _resolve_engine(spec, engine, "plan")
    if profile is not None:
        profile.note(scheme=spec.name, batch=1, engine=resolved)
    if resolved == "batched":
        res = plan_many([net], params, scheme, engine="batched",
                        witness=witness, profile=profile, device=device,
                        **kwargs)
        return plans_from_batch(res, params)[0]
    with spans.span("plan.many", dict(scheme=spec.name, B=1,
                                      engine=resolved)), \
            _total(profile, None):
        return spec.scalar(net, params,
                           **_planner_kwargs(spec, witness, kwargs))


def plan_many(nets: Nets, params: CodeParams, scheme: str,
              engine: str = "auto", witness: str = "exact", profile=None,
              device: DeviceLike = None, **kwargs) -> BatchPlanResult:
    """Plan one scheme across a batch of networks.

    ``nets`` is a ``(B, d+1, d+1)`` capacity array or tensor, or a sequence
    of :class:`OverlayNetwork`.  ``engine="auto"`` (default) takes the
    batched planner where the scheme has one, the scalar loop otherwise;
    ``"batched"`` warns once per scheme when it has to fall back;
    ``"scalar"`` always runs the per-network planners.  The batched engine
    plans on ``device`` (the card unless ``device="cpu"``; a CUDA tensor
    plans on its own device) and returns tensors there.  The scalar path
    returns CPU tensors and carries its plans in ``plans``.

    Mixed fan-outs: a sequence of overlays whose ``d`` differ is bucketed
    by ``d``, each bucket planned in one call against
    ``dataclasses.replace(params, d=...)``, and the rows reassembled in
    input order, padded with zeros to the widest ``d``; the per-network
    plans ride along in ``plans``.
    """
    _check_engine(engine)
    spec = get_scheme(scheme)
    if not hasattr(nets, "shape"):
        nets = list(nets)
        if len({n.d for n in nets}) > 1:
            return _plan_ragged(nets, params, scheme, engine=engine,
                                witness=witness, profile=profile,
                                device=device, **kwargs)
    resolved = _resolve_engine(spec, engine, "plan_many")
    kw = _planner_kwargs(spec, witness, kwargs)
    if profile is not None:
        profile.note(scheme=spec.name, batch=len(nets), d=params.d,
                     engine=resolved, fallback=engine not in ("auto",
                                                              resolved))
    with spans.span("plan.many", dict(scheme=spec.name, B=len(nets),
                                      engine=resolved)):
        if resolved == "batched":
            caps = _caps_on_device(nets, device)
            if spec.accepts_profile and profile is not None:
                kw["profile"] = profile
            with _total(profile, caps.device):
                return spec.batched(caps, params, **kw)
        if hasattr(nets, "shape"):
            arr = (nets.cpu().numpy() if isinstance(nets, torch.Tensor)
                   else nets)
            nets = [OverlayNetwork(c.tolist()) for c in np.asarray(arr)]
        with _total(profile, None):
            plans = [spec.scalar(n, params, **kw) for n in nets]
        return _batch_from_plans(spec, plans, params)


def _plan_ragged(nets: List[OverlayNetwork], params: CodeParams, scheme: str,
                 engine: str, witness: str, profile, device: DeviceLike,
                 **kwargs) -> BatchPlanResult:
    """Mixed fan-outs: one call per bucket of equal ``d``, reassembled in
    input order and padded to the widest ``d``.  Each bucket is planned
    against ``dataclasses.replace(params, d=d_b)``, which keeps (n, k, M,
    alpha) and validates again, so an overlay with d < k raises."""
    d_max = max(n.d for n in nets)
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(nets):
        buckets.setdefault(n.d, []).append(i)
    if profile is not None:
        profile.note(scheme=scheme, batch=len(nets), ragged=True,
                     d_buckets=sorted(buckets))
    subs = []
    for db in sorted(buckets):
        pb = params if db == params.d else dataclasses.replace(params, d=db)
        sub = plan_many([nets[i] for i in buckets[db]], pb, scheme,
                        engine=engine, witness=witness, profile=profile,
                        device=device, **kwargs)
        subs.append((torch.tensor(buckets[db]), db, pb, sub))
    B = len(nets)
    dev = subs[0][3].times.device
    times = torch.full((B,), float("inf"), dtype=torch.float64, device=dev)
    traffic = times.clone()
    lbs = torch.full((B,), float("nan"), dtype=torch.float64, device=dev)
    betas = torch.zeros((B, d_max), dtype=torch.float64, device=dev)
    parents = torch.zeros((B, d_max + 1), dtype=torch.long, device=dev)
    plans: List[Optional[RepairPlan]] = [None] * B
    for idx, db, pb, sub in subs:
        rows = idx.to(dev)
        times[rows] = sub.times.to(dev)
        traffic[rows] = sub.traffic.to(dev)
        betas[rows, :db] = sub.betas.to(dev)
        parents[rows, :db + 1] = sub.parents.to(dev)
        if sub.lower_bounds is not None:
            lbs[rows] = sub.lower_bounds.to(dev)
        for i, p in zip(idx.tolist(), plans_from_batch(sub, pb)):
            plans[i] = p
    engines = {sub.engine for *_, sub in subs}
    has_lbs = any(sub.lower_bounds is not None for *_, sub in subs)
    return BatchPlanResult(
        scheme, times, traffic, betas, parents,
        lower_bounds=lbs if has_lbs else None,
        engine=engines.pop() if len(engines) == 1 else "mixed", plans=plans)


def _batch_from_plans(spec: SchemeSpec, plans: List[RepairPlan],
                      params: CodeParams) -> BatchPlanResult:
    """Pack scalar plans into a CPU :class:`BatchPlanResult`."""
    d = params.d
    B = len(plans)
    parents = np.zeros((B, d + 1), dtype=np.int64)
    betas = np.zeros((B, d))
    lbs = np.full(B, np.nan)
    for b, p in enumerate(plans):
        for u in range(1, d + 1):
            parents[b, u] = p.parent[u]
        betas[b] = p.betas
        if p.lower_bound is not None:
            lbs[b] = p.lower_bound
    times = np.array([p.time for p in plans], dtype=np.float64)
    traffic = np.array([p.total_traffic for p in plans], dtype=np.float64)
    return BatchPlanResult(
        spec.name, torch.from_numpy(times), torch.from_numpy(traffic),
        torch.from_numpy(betas), torch.from_numpy(parents),
        lower_bounds=None if np.isnan(lbs).all() else torch.from_numpy(lbs),
        engine="scalar", plans=plans)


# ---------------------------------------------------------------------------
# Built-in schemes (the paper's family)
# ---------------------------------------------------------------------------

register_scheme("star", plan_star,                        # uniform-beta star [3]
                batched=torch_engine.plan_star_batch)
register_scheme("fr", plan_fr, batched=torch_engine.plan_fr_batch,
                accepts_witness=True, accepts_profile=True)   # Section III
register_scheme("tr", plan_tr,                            # Algorithm 1
                batched=torch_engine.plan_tr_batch)
register_scheme("ftr", plan_ftr, batched=torch_engine.plan_ftr_batch,
                accepts_witness=True, accepts_profile=True)   # Algorithm 2
register_scheme("shah", plan_shah,                        # Shah et al. [6]
                batched=torch_engine.plan_shah_batch)
register_scheme("rctree", plan_rctree)                    # RCTREE [7]
