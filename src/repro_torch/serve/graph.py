"""The serving engine's compiled decode step: the counterpart of the
reference's ``jax.jit`` over ``decode_step`` (``repro.serve.engine``), as
a CUDA graph of one batch size (the engine's slots), captured once and
replayed at every step.

``decode_step`` given its position as a 0-d device tensor reads nothing on
the host, and every shape in it is fixed by the batch size and the cache's
``max_len``; so one capture serves every position of every batch of that
size, as the reference's traced ``jnp.int32`` position lets one executable
do.  A graph owns its static buffers (the cache, a (B, 1) token buffer and
the position), and a replay reads and writes only those.

:class:`EagerDecode` holds the same buffers and makes the same call without
capturing it: the engine's path on the CPU, which only the tests name.
:class:`DecodeGraph` runs on CUDA only, and a failed capture raises: no
path falls back to the eager step.
"""
from __future__ import annotations

import time

import torch

from ..device import DeviceLike, resolve_device
from ..models import Transformer, decode_step, init_cache
from ..models.config import ModelConfig


class EagerDecode:
    """The static buffers of one batch size: ``cache`` (``init_cache(cfg,
    batch, max_len, dtype)``), ``tokens`` ((batch, 1) int32) and ``pos``
    (0-d int32), and ``decode_step`` over them, run eagerly."""

    def __init__(self, cfg: ModelConfig, model: Transformer, batch: int,
                 max_len: int, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.model, self.max_len = cfg, model, max_len
        self.cache = init_cache(cfg, batch, max_len, dtype=dtype,
                                device=self.device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.pos = torch.zeros((), dtype=torch.int32, device=self.device)

    def reset(self) -> None:
        """Zero the cache, as a fresh ``init_cache`` would be."""
        for buf in self.cache.values():
            buf.zero_()

    def _load(self, tokens: torch.Tensor, pos: int) -> None:
        # checked here: past the cache, the device's indexed write would
        # fault instead of raising
        if not 0 <= pos < self.max_len:
            raise IndexError(f"position {pos} outside a cache of "
                             f"{self.max_len}")
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)

    def _step(self) -> torch.Tensor:
        logits, _ = decode_step(self.cfg, self.model, self.cache, self.tokens,
                                self.pos)
        return logits

    def __call__(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """(B, vocab) logits of ``tokens`` ((B, 1)) at position ``pos``; the
        cache is written at ``pos``."""
        self._load(tokens, pos)
        return self._step()


class DecodeGraph(EagerDecode):
    """:class:`EagerDecode`'s step captured into a ``torch.cuda.CUDAGraph``
    with its own memory pool.  The step runs ``WARMUP`` times on a side
    stream first (the libraries' lazy set-up happens outside the capture);
    the cache is zeroed after the capture.  ``__call__`` copies its inputs
    into the buffers, replays the graph and returns the static logits, which
    the next replay overwrites.  ``capture_s`` is the host time of the
    capture and the graph's instantiation."""

    WARMUP = 3

    def __init__(self, cfg: ModelConfig, model: Transformer, batch: int,
                 max_len: int, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        super().__init__(cfg, model, batch, max_len, dtype, dev)
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    self._step()
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph):
                self.logits = self._step()
            self.capture_s = time.perf_counter() - t0
        self.reset()

    def __call__(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        self._load(tokens, pos)
        self.graph.replay()
        return self.logits
