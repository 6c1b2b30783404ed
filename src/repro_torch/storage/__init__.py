"""Simulated distributed storage cluster (paper evaluation substrate)."""
from .capacities import (CapSampler, ClusterCapSampler, FIG7_DISTRIBUTIONS,
                         uniform, uniform_matrix)
from .convert import from_reference_state, to_reference_state
from .simulator import (RlncSimulator, SchemeStats, compare_schemes,
                        reconstruction_vs_rounds)

__all__ = ["CapSampler", "ClusterCapSampler", "FIG7_DISTRIBUTIONS",
           "uniform", "uniform_matrix", "RlncSimulator", "SchemeStats",
           "compare_schemes", "from_reference_state", "reconstruction_vs_rounds",
           "to_reference_state"]
