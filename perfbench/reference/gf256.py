"""GF(2^8) over x^8+x^4+x^3+x^2+1 (0x11D), generator 2: plain tables and
a plain matrix product, for judging coded bytes.

The table construction is a frozen plain copy of ``_tables`` in
src/repro_torch/coding/gf.py at commit 945b8950ea47 (the field the
configurations state).  The product is the definition, one row of the
left operand's coefficients at a time through a 256 x 256 product table:
no bit-matrix form, no kernel.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D


def _tables():
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 256:
            x ^= POLY
    exp[255:] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def _mul_table() -> np.ndarray:
    a = np.arange(256)[:, None]
    b = np.arange(256)[None, :]
    t = EXP[LOG[a] + LOG[b]].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


MUL = _mul_table()

_TABLES = {}


def _mul_on(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(MUL.reshape(-1)).to(device)
    return _TABLES[key]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over GF(2^8) for uint8 A (m, k) and B (k, n) on one
    device: C = XOR over j of A[:, j] * B[j, :], each product read from the
    table."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner sizes {k} and {k2}")
    table = _mul_on(a.device)
    out = torch.zeros((m, n), dtype=torch.uint8, device=a.device)
    rows = a.to(torch.int64) * 256
    for j in range(k):
        out ^= table[rows[:, j:j + 1] + b[j:j + 1].to(torch.int64)]
    return out

