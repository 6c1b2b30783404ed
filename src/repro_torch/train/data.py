"""Deterministic synthetic data pipeline (the counterpart of
``repro.train.data``).

Every batch is a pure function of (seed, step): after a failure and a
restore the pipeline replays exactly, so erasure-coded checkpoint restores
resume the same training (no data-loader state to persist).  The token
stream is a stationary Markov chain (learnable structure: the loss falls
within a few hundred steps, unlike uniform noise).

The successor table ``perm`` is the reference's
(``np.random.default_rng(seed)``).  The reference draws the rest with
threefry, which the port does not reproduce: ``batch_at`` draws the same
distributions from a ``torch.Generator`` on the device, seeded from
(seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    markov_order: float = 0.9   # prob of structured transition vs uniform


class SyntheticLM:
    """Batches on ``device`` (``cuda`` unless ``"cpu"`` is named; raises
    without CUDA)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.mc = model_cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        # sparse deterministic successor table: v_next = perm[v] usually
        self.perm = torch.from_numpy(
            rng.permutation(model_cfg.vocab_size).astype(np.int32)
        ).to(self.device)

    def _generator(self, step: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def batch_at(self, step: int) -> Dict[str, Any]:
        gen = self._generator(step)
        B, S, V = self.cfg.batch, self.cfg.seq_len, self.mc.vocab_size
        kw = dict(device=self.device, generator=gen)
        start = torch.randint(0, V, (B,), dtype=torch.int32, **kw)
        noise = torch.randint(0, V, (B, S + 1), dtype=torch.int32, **kw)
        use_chain = torch.rand((B, S + 1), **kw) < self.cfg.markov_order
        seq = torch.empty((B, S + 1), dtype=torch.int32, device=self.device)
        tok = start
        for t in range(S + 1):
            tok = torch.where(use_chain[:, t], self.perm[tok], noise[:, t])
            seq[:, t] = tok
        batch: Dict[str, Any] = {"tokens": seq[:, :S],
                                 "labels": seq[:, 1:S + 1].clone()}
        if self.mc.frontend == "patch_embed":
            n = self.mc.num_frontend_tokens
            batch["patch_embeds"] = torch.randn(
                (B, n, self.mc.d_model), dtype=torch.float32, **kw)
            batch["labels"][:, :n] = -1
        if self.mc.frontend == "frame_embed":
            batch = {"frames": torch.randn((B, S, self.mc.d_model),
                                           dtype=torch.float32, **kw),
                     "labels": batch["labels"]}
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
