"""Batched serving engine over the models' prefill/decode API (the
counterpart of ``repro.serve``), with its decode step captured as one
CUDA graph on the card."""
from .engine import Completion, Request, ServeEngine
from .graph import DecodeGraph, EagerDecode

__all__ = ["Completion", "DecodeGraph", "EagerDecode", "Request",
           "ServeEngine"]
