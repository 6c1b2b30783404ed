"""The grouped product of a MoE's expert share: rows of ``a`` in group g
(``offs[g-1] <= row < offs[g]``, ``offs`` cumulative row ends on the
device) times ``b[g]``, for a row count per group that only the device
knows.

On CUDA it is PyTorch's grouped product, ``torch._grouped_mm`` (bf16
operands, fp32 accumulation, bf16 output; CUTLASS's grouped GEMM on
sm_90), forward and backward: the matrix products of a layer, as the
dense layers' go to ``torch.matmul``.  No count is read on the host, so a
step that calls it can be captured as a CUDA graph.  The plain version
(:func:`grouped_product_ref`, the CPU's) computes every row's product with
every group's matrix and keeps its own group's, which needs no host read
either.  Rows at or past ``offs[-1]`` are left unspecified on CUDA (the
kernel does not write them, forward or backward) and zero on the CPU:
the caller masks them.

The counter ``moe.launches`` (``obs.spans``) counts the calls, one a
product.
"""
from __future__ import annotations

import torch

from ..obs import spans


def grouped_product_ref(a: torch.Tensor, b: torch.Tensor,
                        offs: torch.Tensor) -> torch.Tensor:
    """a (R, k), b (G, k, n), offs (G,) int32: (R, n), row r of group g
    equal to ``a[r] @ b[g]`` and rows past the last group zero."""
    rows = torch.arange(a.shape[0], device=a.device)
    group = torch.searchsorted(offs, rows.to(offs.dtype), right=True)
    out = torch.zeros(a.shape[0], b.shape[2], dtype=a.dtype, device=a.device)
    for g in range(b.shape[0]):
        out = torch.where((group == g)[:, None], a @ b[g], out)
    return out


def grouped_product(a: torch.Tensor, b: torch.Tensor,
                    offs: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_product_ref`'s function: the grouped product on CUDA
    tensors, the plain version on CPU tensors.  Nothing falls back."""
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1] \
            or offs.shape != (b.shape[0],) or offs.dtype != torch.int32:
        raise ValueError(f"grouped product of {tuple(a.shape)} by "
                         f"{tuple(b.shape)} over offsets {tuple(offs.shape)} "
                         f"{offs.dtype}")
    spans.count("moe.launches")
    if a.device.type == "cuda":
        return torch._grouped_mm(a, b, offs=offs)
    if a.device.type == "cpu":
        return grouped_product_ref(a, b, offs)
    raise ValueError(f"no grouped product for device {a.device}")
