"""Where the port runs: the card, unless the caller asks for the CPU.

Counterpart of ``_on_tpu`` in ``repro.kernels.ops``, with the opposite
default: the reference quietly interprets its kernel on whatever backend it
finds, while every entry point of this package runs on ``cuda`` and raises
when there is none.  The CPU is taken only when asked for by name
(``device="cpu"``), which is how the tests run the plain versions.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None, *,
                   allow_meta: bool = False) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; a CUDA device is returned as
    given.  Either raises ``RuntimeError`` when CUDA is not available.
    ``"cpu"`` is returned only when named.  ``"meta"`` (abstract tensors,
    no data) is returned only with ``allow_meta=True``, which the dry run's
    abstract inputs pass (``launch.specs``, ``launch.dryrun``); any other
    device type raises ``ValueError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu" or (dev.type == "meta" and allow_meta):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
