"""Batched serving engine (the counterpart of ``repro.serve.engine``):
batched prefill, then lock-step decode on the models' (prefill,
decode_step) API, with per-slot stopping.

A fixed number of slots and one shared KV/state cache of ``max_len``;
greedy or temperature sampling.  Requests beyond the slot count queue
FIFO and run in the next batch.  Prompts are left-padded with token 0 and
the pads are attended, positions counting from 0 across the padded prompt,
as in the reference (which has no padding mask).

Sampling runs on the device for the whole batch, with one copy to the host
per step: greedy is an argmax; temperature sampling is a Gumbel-argmax
drawn from the engine's ``torch.Generator`` (seeded by ``seed``, so the
tokens repeat for the same seed; the reference's threefry draws are not
reproduced).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import Transformer, decode_step, init_cache, prefill
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]


class ServeEngine:
    """Serves ``model`` (of ``cfg``) on ``device`` (``cuda`` unless
    ``"cpu"`` is named; raises without CUDA); the model must live there."""

    def __init__(self, cfg: ModelConfig, model: Transformer, slots: int = 4,
                 max_len: int = 256, seed: int = 0,
                 device: DeviceLike = None):
        if cfg.is_encoder_only:
            raise ValueError("decode serving needs a causal LM")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                any_hot: bool) -> torch.Tensor:
        """(B,) next tokens on the device: argmax where the temperature is
        0, else a draw from softmax(logits / temperature)."""
        tok = torch.argmax(logits, dim=-1)
        if not any_hot:
            return tok
        u = torch.rand(logits.shape, generator=self.gen, device=self.device,
                       dtype=torch.float32).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        hot = temps > 0
        drawn = torch.argmax(logits / torch.where(hot, temps, 1.0)[:, None]
                             + gumbel, dim=-1)
        return torch.where(hot, drawn, tok)

    def generate(self, requests: List[Request]) -> List[Completion]:
        """Batches of ``slots`` requests, each prefilled as a batch then
        decoded lock-step until every slot finishes (per-slot early stop
        via a done mask)."""
        out: List[Completion] = []
        queue = list(requests)
        while queue:
            chunk = queue[: self.slots]
            queue = queue[self.slots:]
            out.extend(self._run_batch(chunk))
        return out

    def _run_batch(self, chunk: List[Request]) -> List[Completion]:
        cfg, dev = self.cfg, self.device
        B = len(chunk)
        plen = max(len(r.prompt) for r in chunk)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(chunk):
            # left-pad with token 0 so every prompt ends at index plen-1
            toks[i, plen - len(r.prompt):] = r.prompt
        cache = init_cache(cfg, B, self.max_len,
                           dtype=torch.float32 if cfg.param_dtype == "float32"
                           else torch.bfloat16, device=dev)
        temps = torch.tensor([r.temperature for r in chunk],
                             dtype=torch.float32, device=dev)
        any_hot = any(r.temperature > 0 for r in chunk)
        logits, cache = prefill(cfg, self.model,
                                {"tokens": torch.from_numpy(toks).to(dev)},
                                cache)
        cur = self._sample(logits, temps, any_hot).cpu().numpy()
        results: List[List[int]] = [[int(t)] for t in cur]
        done = [False] * B
        max_new = max(r.max_new_tokens for r in chunk)
        for t in range(1, max_new):
            logits, cache = decode_step(
                cfg, self.model, cache,
                torch.from_numpy(cur[:, None].astype(np.int32)).to(dev),
                plen + t - 1)
            nxt = self._sample(logits, temps, any_hot).cpu().numpy()
            for i, r in enumerate(chunk):
                if done[i] or len(results[i]) >= r.max_new_tokens:
                    done[i] = True
                    continue
                cur[i] = nxt[i]
                results[i].append(int(nxt[i]))
            if all(done):
                break
        return [Completion(rid=r.rid, tokens=results[i])
                for i, r in enumerate(chunk)]
