"""Batched serving engine over the models' prefill/decode API (the
counterpart of ``repro.serve``)."""
from .engine import Completion, Request, ServeEngine

__all__ = ["Completion", "Request", "ServeEngine"]
