"""Judging coded bytes: every coded block carries its coding vector, so a
block is right when its payload equals that vector times the data it
encodes, over GF(2^8).  The judge reads the program's vectors and payload
only at byte columns drawn from the seed, and works the data's own bytes
out from what the benchmark made, never from the program.  Imports
nothing of the program."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import gf256


def wrong_bytes(vectors: torch.Tensor, payload_cols: torch.Tensor,
                data_cols: torch.Tensor) -> int:
    """How many of the sampled payload bytes differ from vectors x data:
    ``vectors`` (r, M), ``payload_cols`` (r, S) and ``data_cols`` (M, S),
    uint8, the sampled columns in the same order."""
    want = gf256.matmul(vectors, data_cols.to(vectors.device))
    return int((want != payload_cols.to(vectors.device)).sum())


def stream_columns(leaves: Sequence[torch.Tensor], blocks: int,
                   block_bytes: int, cols: np.ndarray) -> torch.Tensor:
    """The bytes at columns ``cols`` of each of ``blocks`` blocks of the
    stream made of the leaves' bytes in order (each leaf row-major), zero
    past its end: (blocks, len(cols)) uint8 on the leaves' device.  The
    checkpoint layout a state is saved in."""
    dev = leaves[0].device
    sizes = np.array([t.numel() * t.element_size() for t in leaves],
                     dtype=np.int64)
    ends = np.cumsum(sizes)
    offs = (np.arange(blocks, dtype=np.int64)[:, None] * block_bytes
            + cols[None, :].astype(np.int64)).reshape(-1)
    out = torch.zeros(offs.size, dtype=torch.uint8, device=dev)
    which = np.searchsorted(ends, offs, side="right")
    for i in np.unique(which):
        if i >= len(leaves):
            continue                    # the zero padding
        at = np.nonzero(which == i)[0]
        start = ends[i] - sizes[i]
        flat = leaves[i].detach().contiguous().reshape(-1).view(torch.uint8)
        idx = torch.from_numpy(offs[at] - start).to(dev)
        out[torch.from_numpy(at).to(dev)] = flat.index_select(0, idx)
    return out.view(blocks, len(cols))


def gather_columns(rows: List[torch.Tensor], cols: np.ndarray
                   ) -> torch.Tensor:
    """Columns ``cols`` of each (r, N) uint8 tensor, stacked by rows, on
    the host."""
    idx = torch.from_numpy(cols.astype(np.int64))
    return torch.cat([r.index_select(1, idx.to(r.device)).cpu()
                      for r in rows])
