"""Fault-tolerance layer: erasure-coded checkpoints whose repair engine is
the paper's heterogeneity-aware regeneration planning (the counterpart of
``repro.ft``).  The shards and every coded product live on the coder's
device: the GF(2^8) kernel on the card."""
from .topology import Fleet, FleetConfig
from .erasure import ErasureCoder, EncodedGroup, bytes_to_tree, tree_to_bytes
from .planner import RecoveryDecision, choose_providers, plan_recovery
from .executor import ExecutionReport, execute_regeneration
from .checkpoint import ECCheckpoint, RecoveryLog

__all__ = ["Fleet", "FleetConfig", "ErasureCoder", "EncodedGroup",
           "bytes_to_tree", "tree_to_bytes", "RecoveryDecision",
           "choose_providers", "plan_recovery", "ExecutionReport",
           "execute_regeneration", "ECCheckpoint", "RecoveryLog"]
