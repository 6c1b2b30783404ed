"""The GF(2^8) matmul that the coding plane calls.

``gf_matmul`` dispatches on the tensors' device: a CUDA tensor goes to the
Hopper kernel (``gf_matmul_cuda``), a CPU tensor to the plain PyTorch
version (``gf_matmul_ref``).  Nothing else is taken, and nothing falls back:
when the kernel cannot build or launch, the call raises.  Unlike the
reference's ``repro.kernels.ops`` there is no padding to block multiples;
the kernel masks ragged shapes itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .gf_matmul import gf_matmul_cuda
from .ref import check_operands, gf_matmul_ref


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over GF(2^8) for uint8 A (M, K) and B (K, N) on one
    device: the kernel on CUDA, the plain version on the CPU."""
    check_operands(a, b)
    if a.device.type == "cuda":
        return gf_matmul_cuda(a.contiguous(), b.contiguous())
    if a.device.type == "cpu":
        return gf_matmul_ref(a, b)
    raise ValueError(f"no GF(2^8) matmul for device {a.device}")


def gf_matmul_numpy(a: np.ndarray, b: np.ndarray,
                    device: DeviceLike = None) -> np.ndarray:
    """``gf_matmul`` for callers that hold numpy arrays: the operands are
    moved to ``device`` (the card unless ``"cpu"`` is named) and the
    product comes back as a numpy array."""
    dev = resolve_device(device)
    ta = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(dev)
    tb = torch.from_numpy(np.ascontiguousarray(b, dtype=np.uint8)).to(dev)
    return gf_matmul(ta, tb).cpu().numpy()
