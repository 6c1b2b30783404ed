"""The scalar repair planners of arXiv:1603.05163 (STAR, FR, TR, FTR) as
plain Python and NumPy: frozen copies of the program's scalar planners at
commit 945b8950ea47, which the benchmark holds the card's batched planning
tier to.  Nothing here imports the program."""
from .params import CodeParams, OverlayNetwork, RepairPlan, plan_time, tree_flows
from .star import plan_fr, plan_star
from .tree import plan_tr
from .ftr import plan_ftr

PLANNERS = {"star": plan_star, "fr": plan_fr, "tr": plan_tr, "ftr": plan_ftr}
