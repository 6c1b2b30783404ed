"""PyTorch and CUDA port of the regeneration-planning system in ``repro``.

The package mirrors ``repro``'s module names (``coding``, ``kernels``,
``core``, ``storage``) and imports nothing from it: the reference and the
port meet only in the tests.  Entry points run on the card unless the
caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
