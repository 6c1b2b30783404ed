"""Regeneration planning: parameters, feasible regions, the scalar planners
and the scheme registry (a copy of ``repro.core``'s host code).

Schemes (all return :class:`~repro_torch.core.params.RepairPlan`):
``plan_star``, ``plan_fr``, ``plan_tr``, ``plan_ftr``, ``plan_shah`` and
``plan_rctree``, dispatched through ``plan()`` / ``plan_many()``.  The
planners keep the reference's float arithmetic unchanged, so plans match it.
"""
from .params import (CodeParams, Edge, OverlayNetwork, RepairPlan, mbr_point,
                     msr_point, plan_time, tree_flows, uniform_beta)
from .regions import (FeasibleRegion, heuristic_region, msr_region, sigma,
                      shah_region_thresholds, uniform_point)
from .star import fr_closed_form_msr, plan_fr, plan_shah, plan_star
from .tree import plan_tr, tree_time_uniform
from .ftr import eval_tree, plan_ftr
from .rctree import plan_rctree
from .api import (SchemeSpec, get_scheme, plan, plan_many, register_scheme,
                  scheme_names)

__all__ = [
    "CodeParams", "Edge", "FeasibleRegion",
    "OverlayNetwork", "RepairPlan", "SchemeSpec", "eval_tree",
    "fr_closed_form_msr", "get_scheme", "heuristic_region", "mbr_point",
    "msr_point", "msr_region", "plan", "plan_fr", "plan_ftr", "plan_many",
    "plan_rctree", "plan_shah", "plan_star", "plan_time", "plan_tr",
    "register_scheme", "scheme_names", "shah_region_thresholds", "sigma",
    "tree_flows", "tree_time_uniform", "uniform_beta", "uniform_point",
]
