"""A GF(2^8) product wrapper, passed as a coder's ``matmul=``, that times
each product on the card and keeps its shape.  (``ShapeLog`` of
chip_smoke.py at commit 945b8950ea47.)"""
from __future__ import annotations

import torch


class ProductLog:
    """Brackets every call with CUDA events on the current stream and
    passes it on unchanged.  The output's memory is taken from the
    allocator before the start event and freed at once, so the events hold
    the launch, not the allocator mapping new memory.  ``on`` switches the
    logging (set-up products are left out)."""

    def __init__(self, matmul):
        self.matmul = matmul
        self.on = False
        self.events = []          # [((M, K, N), start, end), ...]

    def __call__(self, a, b):
        if not self.on or a.device.type != "cuda":
            return self.matmul(a, b)
        shape = (a.shape[0], a.shape[1], b.shape[1])
        torch.empty(shape[0] * shape[2], dtype=torch.uint8, device=a.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.matmul(a, b)
        end.record()
        self.events.append((shape, start, end))
        return out

    def readings(self):
        """[((M, K, N), seconds)], after a synchronize."""
        return [(shape, s.elapsed_time(e) / 1e3)
                for shape, s, e in self.events]
