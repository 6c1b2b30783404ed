"""Finite-field arithmetic for the regenerating code (GF(2^8) and GF(2^16)).

GF(2^8) uses the standard storage-systems polynomial x^8+x^4+x^3+x^2+1
(0x11D) with generator 2; GF(2^16) uses 0x1100B.  Everything here is
table-based NumPy on the host: coefficient draws, rank tests and the
elimination of a decode.  The products over payload bytes run on the card
through ``repro_torch.kernels``.  Each method gives the same bits as its
counterpart in ``repro.coding.gf``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

GF8_POLY = 0x11D
GF16_POLY = 0x1100B
_RANDOM_SLAB = 1 << 24   # elements drawn per call by GF.random


@functools.lru_cache(maxsize=None)
def _tables(bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """(EXP, LOG) tables.  EXP has 2*(q-1) entries to skip the mod."""
    poly = GF8_POLY if bits == 8 else GF16_POLY
    q = 1 << bits
    exp = np.zeros(2 * (q - 1), dtype=np.int64)
    log = np.zeros(q, dtype=np.int64)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= poly
    exp[q - 1:] = exp[: q - 1]
    return exp, log


class GF:
    """Galois field GF(2^bits), bits in {8, 16}; numpy vectorized."""

    def __init__(self, bits: int = 8):
        if bits not in (8, 16):
            raise ValueError("bits must be 8 or 16")
        self.bits = bits
        self.q = 1 << bits
        self.poly = GF8_POLY if bits == 8 else GF16_POLY
        self.exp, self.log = _tables(bits)
        self.dtype = np.uint8 if bits == 8 else np.uint16
        # Narrow tables for the blocked matmul.  mul_log[0] points past the
        # live EXP region, where mul_exp is zero — so products with a zero
        # operand come out 0 straight from the gather, with no mask pass.
        # Narrow dtypes keep the (m, bk, n) product block cache-resident.
        q1 = self.q - 1
        self.mul_exp = np.zeros(4 * q1 + 1, dtype=self.dtype)
        self.mul_exp[:2 * q1] = self.exp.astype(self.dtype)
        self.mul_log = self.log.astype(np.int32)
        self.mul_log[0] = 2 * q1

    # -- scalar/elementwise ------------------------------------------------

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out).astype(self.dtype)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF")
        return self.exp[(self.q - 1) - self.log[a]].astype(self.dtype)

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, e: int):
        a = np.asarray(a, dtype=np.int64)
        if e == 0:
            return np.ones_like(a, dtype=self.dtype)
        la = self.log[a] * (e % (self.q - 1))
        out = self.exp[la % (self.q - 1)]
        return np.where(a == 0, 0, out).astype(self.dtype)

    # -- linear algebra ----------------------------------------------------

    def matmul(self, A: np.ndarray, B: np.ndarray,
               block_k: int | None = None) -> np.ndarray:
        """C = A @ B over GF (XOR-accumulate of field products).

        Blocked table-lookup formulation: a whole K-chunk of outer products
        is gathered from the narrow EXP table as one (m, bk, n) lookup and
        folded with a single XOR reduction.  ``block_k`` keeps the
        field-dtype temporary inside ~2 MB (cache-resident) by default.
        Host arrays only; tensors on the card go through
        ``repro_torch.kernels.ops.gf_matmul``.
        """
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        assert A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0]
        m, K = A.shape
        n = B.shape[1]
        if block_k is None:
            # working set per block: the int32 index intermediate (4 B/elem)
            # plus the field-dtype product — size both into ~2 MB
            elem_bytes = 4 + self.dtype().itemsize
            block_k = max(1, min(K, (1 << 21) // max(1, m * n * elem_bytes)))
        logA = self.mul_log[A]
        logB = self.mul_log[B]
        out = np.zeros((m, n), dtype=self.dtype)
        for k0 in range(0, K, block_k):
            k1 = min(k0 + block_k, K)
            out ^= np.bitwise_xor.reduce(
                self.mul_exp[logA[:, k0:k1, None] + logB[None, k0:k1, :]],
                axis=1)
        return out

    def rank(self, A: np.ndarray) -> int:
        """Rank over GF via Gaussian elimination."""
        A = np.array(A, dtype=np.int64, copy=True)
        rows, cols = A.shape
        r = 0
        for c in range(cols):
            piv = None
            for i in range(r, rows):
                if A[i, c]:
                    piv = i
                    break
            if piv is None:
                continue
            A[[r, piv]] = A[[piv, r]]
            inv = int(self.inv(A[r, c]))
            A[r] = self.mul(A[r], inv)
            mask = A[:, c] != 0
            mask[r] = False
            if mask.any():
                A[mask] ^= self.mul(A[mask, c][:, None], A[r][None, :]).astype(np.int64)
            r += 1
            if r == rows:
                break
        return r

    def solve(self, A: np.ndarray, Y: np.ndarray) -> np.ndarray:
        """Solve A X = Y over GF (A square, invertible)."""
        A = np.array(A, dtype=np.int64, copy=True)
        Y = np.array(Y, dtype=np.int64, copy=True)
        n = A.shape[0]
        assert A.shape == (n, n) and Y.shape[0] == n
        for c in range(n):
            piv = None
            for i in range(c, n):
                if A[i, c]:
                    piv = i
                    break
            if piv is None:
                raise np.linalg.LinAlgError("singular GF matrix")
            A[[c, piv]] = A[[piv, c]]
            Y[[c, piv]] = Y[[piv, c]]
            inv = int(self.inv(A[c, c]))
            A[c] = self.mul(A[c], inv)
            Y[c] = self.mul(Y[c], inv)
            mask = A[:, c] != 0
            mask[c] = False
            if mask.any():
                f = A[mask, c][:, None]
                A[mask] ^= self.mul(f, A[c][None, :]).astype(np.int64)
                Y[mask] ^= self.mul(f, Y[c][None, :]).astype(np.int64)
        return Y.astype(self.dtype)

    def inv_matrix(self, A: np.ndarray) -> np.ndarray:
        n = A.shape[0]
        return self.solve(A, np.eye(n, dtype=np.int64))

    # -- structured generators ----------------------------------------------

    def cauchy_matrix(self, rows: int, cols: int) -> np.ndarray:
        """Cauchy matrix: every square submatrix is nonsingular (true MDS).
        Requires rows + cols <= q."""
        if rows + cols > self.q:
            raise ValueError(f"Cauchy needs rows+cols <= {self.q}")
        x = np.arange(rows, dtype=np.int64)
        y = np.arange(rows, rows + cols, dtype=np.int64)
        return self.inv((x[:, None] ^ y[None, :]).astype(np.int64)).astype(self.dtype)

    def random(self, shape, rng: np.random.Generator) -> np.ndarray:
        """Uniform field elements drawn as
        ``rng.integers(0, q, size=shape, dtype=np.uint32)``.

        Large shapes are drawn a slab of leading rows at a time: the
        generator buffers its 32-bit halves across calls, so the stream and
        the result are the same as one call, without the 4-byte temporary of
        the whole array."""
        shape = tuple(np.atleast_1d(shape).tolist())
        rows = shape[0]
        per_row = int(np.prod(shape[1:], dtype=np.int64))
        step = max(1, _RANDOM_SLAB // max(per_row, 1))
        out = np.empty(shape, dtype=self.dtype)
        for r0 in range(0, rows, step):
            r1 = min(r0 + step, rows)
            out[r0:r1] = rng.integers(0, self.q, size=(r1 - r0,) + shape[1:],
                                      dtype=np.uint32)
        return out


GF8 = GF(8)
GF16 = GF(16)
