"""Batched serving engine (the counterpart of ``repro.serve.engine``):
batched prefill, then lock-step decode on the models' (prefill,
decode_step) API, with per-slot stopping.

A fixed number of slots and one shared KV/state cache of ``max_len``;
greedy or temperature sampling.  Requests beyond the slot count queue
FIFO and run in the next batch.  Prompts are left-padded with token 0 and
the pads are attended, positions counting from 0 across the padded prompt,
as in the reference (which has no padding mask).

Every decode step on the card replays a CUDA graph (``graph.DecodeGraph``),
as the reference's step replays one compiled executable.  The engine keeps
one graph of ``slots`` rows, with its own cache, for its whole life: a
batch zeroes that cache and prefills its own rows of it eagerly, and every
step replays the graph over all the rows, a short chunk's spare rows fed
token 0 and never sampled.  Each row decodes on its own (attention, the SSM
and the MoE's expert capacity are per row), so a spare row changes no
other row's tokens.  On the CPU, which only the tests name, the same
buffers and the same ``decode_step`` call run eagerly
(``graph.EagerDecode``).

Sampling runs on the device for the whole batch, outside the graph, with one
copy to the host per step: greedy is an argmax; temperature sampling is a
Gumbel-argmax drawn from the engine's ``torch.Generator`` (seeded by
``seed``, so the tokens repeat for the same seed; the reference's threefry
draws are not reproduced).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import Transformer, prefill
from ..models.config import ModelConfig
from .graph import DecodeGraph, EagerDecode


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
        # the decode buffers of ``slots`` rows (a captured graph on the
        # card), built by the first batch
        self.decoder: Optional[EagerDecode] = None

    def _decoder(self) -> EagerDecode:
        """The decode buffers with a zeroed cache."""
        if self.decoder is None:
            make = DecodeGraph if self.device.type == "cuda" else EagerDecode
            self.decoder = make(
                self.cfg, self.model, self.slots, self.max_len,
                dtype=torch.float32 if self.cfg.param_dtype == "float32"
                else torch.bfloat16, device=self.device)
        else:
            self.decoder.reset()
        return self.decoder

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
        dec = self._decoder()
        temps = torch.tensor([r.temperature for r in chunk],
                             dtype=torch.float32, device=dev)
        any_hot = any(r.temperature > 0 for r in chunk)
        # the chunk's rows of the cache (batch is dim 1 of every buffer)
        logits, _ = prefill(cfg, self.model,
                            {"tokens": torch.from_numpy(toks).to(dev)},
                            {k: v[:, :B] for k, v in dec.cache.items()})
        cur = self._sample(logits, temps, any_hot).cpu().numpy()
        results: List[List[int]] = [[int(t)] for t in cur]
        done = [False] * B
        max_new = max(r.max_new_tokens for r in chunk)
        feed = np.zeros((self.slots, 1), np.int32)     # spare rows: token 0
        for t in range(1, max_new):
            feed[:B, 0] = cur
            logits = dec(torch.from_numpy(feed), plen + t - 1)
            nxt = self._sample(logits[:B], temps, any_hot).cpu().numpy()
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
