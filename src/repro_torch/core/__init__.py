"""Regeneration planning: parameters, feasible regions, the scalar planners,
the device planning tier and the scheme registry (the counterpart of
``repro.core``).

Schemes (all return :class:`~repro_torch.core.params.RepairPlan`):
``plan_star``, ``plan_fr``, ``plan_tr``, ``plan_ftr``, ``plan_shah`` and
``plan_rctree``, copied from the reference with their float arithmetic,
and ``plan_ort_uniform`` / ``plan_ort_flexible``, the exact brute force for
small d.  Their batch counterparts (``plan_*_batch``, in
:mod:`.torch_engine`) plan a whole batch as float64 tensor programs on the
card.  ``plan()`` and ``plan_many()`` dispatch through the registry.
``InfoFlowGraph`` verifies the MDS property of a repair history by
max-flow (Lemma 1).
"""
from .params import (CodeParams, Edge, OverlayNetwork, RepairPlan, mbr_point,
                     msr_point, plan_time, tree_flows, uniform_beta)
from .regions import (FeasibleRegion, heuristic_region, msr_region, sigma,
                      shah_region_thresholds, theorem6_example, uniform_point)
from .star import fr_closed_form_msr, plan_fr, plan_shah, plan_star
from .tree import plan_tr, tree_time_uniform
from .ftr import eval_tree, plan_ftr
from .ort import iter_rooted_trees, plan_ort_flexible, plan_ort_uniform
from .rctree import plan_rctree
from .infoflow import InfoFlowGraph, RepairEvent, event_from_plan
from .extensions import (plan_multi_failures, store_and_forward_time,
                         streaming_time_with_latency)
from .batched import (BatchPlanResult, caps_tensor, plans_from_batch,
                      plans_from_batches)
from .torch_engine import (plan_fr_batch, plan_ftr_batch, plan_shah_batch,
                           plan_star_batch, plan_tr_batch)
from .api import (SchemeSpec, get_scheme, plan, plan_many, register_scheme,
                  scheme_names)
from .witness import (level_cut, level_cut_batch, min_traffic_batch,
                      tree_traffic_batch)

__all__ = [
    "BatchPlanResult", "CodeParams", "Edge", "FeasibleRegion",
    "InfoFlowGraph", "OverlayNetwork", "RepairEvent", "RepairPlan",
    "SchemeSpec", "caps_tensor", "eval_tree", "event_from_plan",
    "fr_closed_form_msr", "get_scheme", "heuristic_region",
    "iter_rooted_trees", "level_cut", "level_cut_batch", "mbr_point",
    "min_traffic_batch", "msr_point", "msr_region", "plan", "plan_fr",
    "plan_fr_batch", "plan_ftr", "plan_ftr_batch", "plan_many",
    "plan_multi_failures", "plan_ort_flexible", "plan_ort_uniform",
    "plan_rctree", "plan_shah", "plan_shah_batch", "plan_star",
    "plan_star_batch", "plan_time", "plan_tr", "plan_tr_batch",
    "plans_from_batch", "plans_from_batches", "register_scheme",
    "scheme_names",
    "shah_region_thresholds", "sigma", "store_and_forward_time",
    "streaming_time_with_latency", "theorem6_example", "tree_flows",
    "tree_time_uniform", "tree_traffic_batch", "uniform_beta",
    "uniform_point",
]
