"""Plain PyTorch GF(2^8) matrix product: the reference for the kernel.

The same bit-plane algorithm as ``repro.kernels.ref.gf_matmul_ref``:

  * expand A and B into 8 one-bit planes each;
  * plane t of the 15-coefficient carry-less product is the parity of
    sum_{i+j=t} A_i @ B_j, an ordinary matmul of 0/1 matrices;
  * reduce the 15 planes mod x^8+x^4+x^3+x^2+1 (0x11D): x^8 == 0x1D, so
    plane t >= 8 folds into planes t-8+{0,2,3,4} (high to low);
  * pack the 8 low planes into bytes.

CUDA PyTorch has no integer matmul, so the plane products are float32
matmuls.  They are exact: every entry is a count of at most 8K, an integer
below 2^24 while K < 2^21.  All 64 plane products of a column chunk come out
of one (8M, K) @ (K, 8n) matmul.  The payload is taken in column chunks so
that the product block stays within ``_CHUNK_ELEMS`` floats at N = 4 MiB.

It runs on CPU and CUDA tensors alike: the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

# bit positions of 0x1D = x^4 + x^3 + x^2 + 1 (x^8 reduced)
_FOLD = (0, 2, 3, 4)
_CHUNK_ELEMS = 1 << 28   # float32 elements of one (8M, 8n) product block
_MAX_K = 1 << 21         # 8K plane counts must stay below 2^24


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless ``a`` (M, K) and ``b`` (K, N) are uint8 matrices on one
    device."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need A (M, K) and B (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"need uint8 operands, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _bit_planes(x: torch.Tensor, dim: int) -> torch.Tensor:
    """0/1 float32 planes of a uint8 matrix, stacked along a new axis at
    ``dim`` (bit i at index i)."""
    shifts = torch.arange(8, device=x.device, dtype=torch.int32)
    shape = [1, 1, 1]
    shape[dim] = 8
    return ((x.to(torch.int32).unsqueeze(dim) >> shifts.view(shape)) & 1
            ).to(torch.float32)


def gf_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over GF(2^8), A:(M,K) uint8, B:(K,N) uint8 -> (M,N) uint8."""
    check_operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    if K >= _MAX_K:
        raise ValueError(f"K={K} too large for exact float32 plane counts")
    out = torch.empty((M, N), dtype=torch.uint8, device=a.device)
    if M == 0 or N == 0:
        return out
    abits = _bit_planes(a, 0).reshape(8 * M, K)          # row i*M+m = A_i[m]
    step = max(1, _CHUNK_ELEMS // (64 * M))
    for n0 in range(0, N, step):
        bc = b[:, n0:n0 + step]
        nc = bc.shape[1]
        bbits = _bit_planes(bc, 1).reshape(K, 8 * nc)    # col j*nc+n = B_j[:, n]
        prod = (abits @ bbits).view(8, M, 8, nc)         # [i, :, j, :] = A_i @ B_j
        planes = []
        for t in range(15):
            acc = None
            for i in range(max(0, t - 7), min(7, t) + 1):
                term = prod[i, :, t - i, :]
                acc = term if acc is None else acc + term
            planes.append(acc.to(torch.int32) & 1)
        for t in range(14, 7, -1):
            p = planes[t]
            for s in _FOLD:
                planes[t - 8 + s] = planes[t - 8 + s] ^ p
        c = planes[0]
        for t in range(1, 8):
            c = c | (planes[t] << t)
        out[:, n0:n0 + nc] = c.to(torch.uint8)
    return out
