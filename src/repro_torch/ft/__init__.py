"""Fault-tolerance layer (the counterpart of ``repro.ft``).  So far only the
fleet topology, which the fleet simulator's tiered scenario samples."""
from .topology import Fleet, FleetConfig

__all__ = ["Fleet", "FleetConfig"]
