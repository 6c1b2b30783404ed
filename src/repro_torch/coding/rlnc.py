"""Random linear network coding data plane (paper Section II-A).

A file of M blocks a_1..a_M is encoded into n*alpha coded blocks b_i =
sum_j c_ij a_j and spread over n nodes (alpha blocks each).  Every coded
block carries its length-M coding vector.  Regeneration, relaying and
reconstruction are GF(2^8) matrix products on (coding-vector, payload)
pairs, which run on the card through ``repro_torch.kernels.ops.gf_matmul``.

Coefficients are drawn on the host from the caller's numpy generator, with
exactly the draws of ``repro.coding.rlnc``, so the port's blocks equal the
reference's bit for bit.  Rank tests and the choice of decode rows are host
work on the (small) coding vectors; the decode product over the payload
runs on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.ops import gf_matmul
from ..obs import spans
from .gf import GF, GF8

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class CodedBlocks:
    """A batch of coded blocks: coding vectors (num, M) and payload
    (num, block_bytes), uint8 tensors on one device."""

    vectors: torch.Tensor
    payload: torch.Tensor

    def __post_init__(self):
        if self.vectors.shape[0] != self.payload.shape[0]:
            raise ValueError(f"{self.vectors.shape[0]} vectors for "
                             f"{self.payload.shape[0]} payload rows")
        if self.vectors.device != self.payload.device:
            raise ValueError("vectors and payload on different devices")

    @property
    def num(self) -> int:
        return self.vectors.shape[0]

    def concat(self, other: "CodedBlocks") -> "CodedBlocks":
        return CodedBlocks(torch.cat([self.vectors, other.vectors]),
                           torch.cat([self.payload, other.payload]))


def independent_rows(field: GF, V: np.ndarray, limit: int) -> List[int]:
    """Indices of the first ``limit`` rows of ``V`` that are independent of
    the rows picked before them, in order: the rows that
    ``repro.coding.rlnc.RLNC.reconstruct`` picks with one rank call per row.

    One incremental pass: the picked rows are kept in reduced row echelon
    form (each pivot column is zero in every other kept row), so a
    candidate is reduced against all of them by one product, and is picked
    when something is left.  May return fewer than ``limit`` rows.
    """
    V = np.asarray(V, dtype=np.int64)
    cols = V.shape[1]
    basis = np.zeros((0, cols), dtype=np.int64)
    pivots: List[int] = []
    picked: List[int] = []
    for i in range(V.shape[0]):
        if len(picked) == limit:
            break
        v = V[i]
        if pivots:
            v = v ^ field.matmul(v[pivots][None, :], basis)[0].astype(np.int64)
        nz = np.flatnonzero(v)
        if nz.size == 0:
            continue
        p = int(nz[0])
        v = field.mul(v, int(field.inv(v[p]))).astype(np.int64)
        col = basis[:, p]
        if col.any():
            basis = basis ^ field.mul(col[:, None], v[None, :]).astype(np.int64)
        basis = np.concatenate([basis, v[None, :]])
        pivots.append(p)
        picked.append(i)
    return picked


class RLNC:
    """Stateless coding operations over GF(2^8), on one device.

    ``matmul`` defaults to ``ops.gf_matmul``: the kernel on the card, the
    plain version on the CPU.
    """

    def __init__(self, field: GF = GF8, matmul: Optional[Matmul] = None,
                 device: DeviceLike = None):
        if field.bits != 8:
            raise ValueError("the port's coding plane is GF(2^8) only")
        self.field = field
        self.device = resolve_device(device)
        self._matmul = matmul if matmul is not None else gf_matmul

    def random(self, shape, rng: np.random.Generator) -> torch.Tensor:
        """``field.random`` (host draws) moved to this device."""
        return torch.from_numpy(self.field.random(shape, rng)).to(self.device)

    # -- file distribution ---------------------------------------------------

    def distribute(self, file_blocks: torch.Tensor, n: int, alpha: int,
                   rng: np.random.Generator) -> List[CodedBlocks]:
        """Encode M file blocks into n nodes * alpha coded blocks (random
        linear code; MDS with probability -> 1 for large fields)."""
        M = file_blocks.shape[0]
        C = self.random((n * alpha, M), rng)
        payload = self._matmul(C, file_blocks)
        return [CodedBlocks(C[i * alpha:(i + 1) * alpha],
                            payload[i * alpha:(i + 1) * alpha])
                for i in range(n)]

    # -- regeneration --------------------------------------------------------

    def encode(self, local: CodedBlocks, num_out: int,
               rng: np.random.Generator) -> CodedBlocks:
        """Provider-side: num_out random combinations of the local blocks."""
        with spans.span("rlnc.encode"):
            R = self.random((num_out, local.num), rng)
            return CodedBlocks(self._matmul(R, local.vectors),
                               self._matmul(R, local.payload))

    def relay(self, received: CodedBlocks, own: CodedBlocks, num_out: int,
              rng: np.random.Generator) -> CodedBlocks:
        """Interior tree node: re-encode (received ++ freshly generated own
        data) down to num_out blocks (Section V-A)."""
        with spans.span("rlnc.relay"):
            pool = received.concat(own)
            R = self.random((num_out, pool.num), rng)
            return CodedBlocks(self._matmul(R, pool.vectors),
                               self._matmul(R, pool.payload))

    def regenerate(self, received: CodedBlocks, alpha: int,
                   rng: np.random.Generator) -> CodedBlocks:
        """Newcomer: store alpha random combinations of everything received."""
        with spans.span("rlnc.regenerate"):
            R = self.random((alpha, received.num), rng)
            return CodedBlocks(self._matmul(R, received.vectors),
                               self._matmul(R, received.payload))

    # -- reconstruction --------------------------------------------------------

    def can_reconstruct(self, nodes: Sequence[CodedBlocks], M: int) -> bool:
        V = torch.cat([nd.vectors for nd in nodes]).cpu().numpy()
        return self.field.rank(V) >= M

    def reconstruct(self, nodes: Sequence[CodedBlocks], M: int) -> torch.Tensor:
        """Recover the original M file blocks from >= M independent coded
        blocks (MDS reconstruction, Section II-A).

        The first M independent rows in order are chosen on the host, their
        M x M coefficient matrix is inverted on the host, and the inverse is
        applied to their payload on this device."""
        V = torch.cat([nd.vectors for nd in nodes]).cpu().numpy()
        idx = independent_rows(self.field, V, M)
        if len(idx) < M:
            raise ValueError(f"rank {len(idx)} < M={M}: cannot reconstruct")
        inv = self.field.inv_matrix(V[idx])
        return self._matmul(torch.from_numpy(inv).to(self.device),
                            _take_rows([nd.payload for nd in nodes], idx))


def _take_rows(parts: Sequence[torch.Tensor], idx: List[int]) -> torch.Tensor:
    """Rows ``idx`` (increasing) of the parts stacked in order, gathered in
    one copy: a part whose rows are all taken joins whole, the others give
    only the rows taken."""
    pieces, off = [], 0
    for part in parts:
        n = part.shape[0]
        sel = [i - off for i in idx if off <= i < off + n]
        if sel == list(range(n)):
            pieces.append(part)
        elif sel:
            pieces.append(part.index_select(
                0, torch.tensor(sel, device=part.device)))
        off += n
    return torch.cat(pieces)
