"""Planner API: the scheme registry behind ``plan()`` / ``plan_many()``.

The counterpart of ``repro.core.api``, trimmed to the scalar planners: the
planners are host code in this package until the device planning tier
(``torch_engine``, the counterpart of ``repro.core.batched`` and
``repro.core.jax_engine``) lands.  ``engine`` accepts ``"auto"`` and
``"scalar"``, which both run the scalar planners; ``"batched"`` raises
``NotImplementedError`` until that tier exists.  ``witness=`` reaches
exactly the schemes that declared ``accepts_witness``; other keyword
arguments pass through to the planner.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .params import CodeParams, OverlayNetwork, RepairPlan
from .star import plan_fr, plan_shah, plan_star
from .tree import plan_tr
from .ftr import plan_ftr
from .rctree import plan_rctree

__all__ = ["SchemeSpec", "get_scheme", "plan", "plan_many",
           "register_scheme", "scheme_names"]

ScalarPlanner = Callable[..., RepairPlan]
ENGINES = ("auto", "scalar")


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One registered regeneration scheme: its scalar planner
    ``(net, params, **kw) -> RepairPlan`` and whether that planner takes
    the ``witness=`` selector."""

    name: str
    scalar: ScalarPlanner
    accepts_witness: bool = False


_REGISTRY: Dict[str, SchemeSpec] = {}


def register_scheme(name: str, scalar: Optional[ScalarPlanner] = None, *,
                    accepts_witness: bool = False):
    """Register a scheme; usable directly (returns the :class:`SchemeSpec`)
    or as a decorator (returns the planner unchanged).  Registering a name
    twice raises."""
    def _register(fn: ScalarPlanner) -> SchemeSpec:
        if name in _REGISTRY:
            raise ValueError(f"scheme {name!r} is already registered")
        spec = SchemeSpec(name=name, scalar=fn,
                          accepts_witness=accepts_witness)
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


def _check_engine(engine: str) -> None:
    if engine == "batched":
        raise NotImplementedError(
            "engine='batched' arrives with the device planning tier "
            "(repro_torch.core.torch_engine) in a later slice of the port; "
            "use engine='auto' or 'scalar'")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def _planner_kwargs(spec: SchemeSpec, witness: str, kwargs: dict) -> dict:
    kw = dict(kwargs)
    if spec.accepts_witness:
        kw["witness"] = witness
    return kw


def plan(net: OverlayNetwork, params: CodeParams, scheme: str,
         engine: str = "auto", witness: str = "exact",
         **kwargs) -> RepairPlan:
    """Plan one regeneration of ``net`` with ``scheme``'s scalar planner."""
    _check_engine(engine)
    spec = get_scheme(scheme)
    return spec.scalar(net, params, **_planner_kwargs(spec, witness, kwargs))


def plan_many(nets: Sequence[OverlayNetwork], params: CodeParams,
              scheme: str, engine: str = "auto", witness: str = "exact",
              **kwargs) -> List[RepairPlan]:
    """Plan one scheme for each overlay of ``nets`` (all of fan-out
    ``params.d``) with the scalar loop; returns the plans in order."""
    _check_engine(engine)
    spec = get_scheme(scheme)
    nets = list(nets)
    if any(n.d != params.d for n in nets):
        raise ValueError(f"every overlay needs d={params.d}; mixed fan-outs "
                         f"arrive with the device planning tier")
    kw = _planner_kwargs(spec, witness, kwargs)
    return [spec.scalar(n, params, **kw) for n in nets]


# ---------------------------------------------------------------------------
# Built-in schemes (the paper's family)
# ---------------------------------------------------------------------------

register_scheme("star", plan_star)                        # uniform-beta star [3]
register_scheme("fr", plan_fr, accepts_witness=True)      # Section III
register_scheme("tr", plan_tr)                            # Algorithm 1
register_scheme("ftr", plan_ftr, accepts_witness=True)    # Algorithm 2
register_scheme("shah", plan_shah)                        # Shah et al. [6]
register_scheme("rctree", plan_rctree)                    # RCTREE [7]
