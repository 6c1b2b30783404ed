"""The benchmark's inputs, drawn from ``--seed``: a model's weights, token
batches, link capacities, repair draws.  The same seed gives the same
inputs; the program receives only what is drawn here."""
from __future__ import annotations

import collections
import math
from typing import List, Tuple

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent host stream per use, from (seed, stream)."""
    return np.random.default_rng([int(seed), int(stream)])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(stream)])
                      .generate_state(1, np.uint64)[0]))
    return g


# ---------------------------------------------------------------------------
# a decoder's weights
# ---------------------------------------------------------------------------

def decoder_leaves(model: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every weight of a dense decoder with
    non-parametric norms, under the program's parameter names: normals of
    std 1/sqrt(fan-in), the embeddings 1/sqrt(d_model); no output head of
    its own where the model ties it to the token embedding."""
    d, H, hd, f, V = (model["d_model"], model["num_heads"],
                      model["head_dim"], model["d_ff"], model["vocab_size"])
    out = []
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        out += [(p + "attn.wq", (d, H, hd), 1 / math.sqrt(d)),
                (p + "attn.wk", (d, H, hd), 1 / math.sqrt(d)),
                (p + "attn.wv", (d, H, hd), 1 / math.sqrt(d)),
                (p + "attn.wo", (H, hd, d), 1 / math.sqrt(H * hd)),
                (p + "mlp.w_gate", (d, f), 1 / math.sqrt(d)),
                (p + "mlp.w_up", (d, f), 1 / math.sqrt(d)),
                (p + "mlp.w_down", (f, d), 1 / math.sqrt(f))]
    out.append(("embed.tok", (V, d), 1 / math.sqrt(d)))
    if not model.get("tie_embeddings", False):
        out.append(("embed.unembed", (V, d), 1 / math.sqrt(d)))
    return out


def decoder_weights(model: dict, seed: int, device, dtype=torch.bfloat16
                    ) -> "collections.OrderedDict[str, torch.Tensor]":
    """Every weight as a view of one buffer drawn on ``device`` by one
    normal draw, then scaled leaf by leaf, in ``dtype``."""
    leaves = decoder_leaves(model)
    total = sum(math.prod(s) for _, s, _ in leaves)
    buf = torch.randn(total, dtype=dtype, device=device,
                      generator=device_generator(seed, 1, device))
    out, off = collections.OrderedDict(), 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape).mul_(std)
        off += n
    return out


# ---------------------------------------------------------------------------
# token batches
# ---------------------------------------------------------------------------

def lm_batches(seed: int, vocab: int, batch: int, seq_len: int, count: int,
               markov_order: float, device) -> List[Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """``count`` batches of (tokens, labels), each (batch, seq_len) int32:
    a stationary Markov chain over the vocabulary (a fixed random successor
    with probability ``markov_order``, else a uniform token), so the loss
    has structure to learn.  Every row differs.  Drawn on the host in one
    pass over the positions, for every row of every batch at once.  (The
    chain of ``repro_torch.train.data.SyntheticLM``, at commit
    945b8950ea47, drawn from the benchmark's own streams.)"""
    r = rng(seed, 2)
    perm = r.permutation(vocab).astype(np.int64)
    rows = count * batch
    tok = r.integers(0, vocab, rows)
    noise = r.integers(0, vocab, (seq_len + 1, rows))
    chain = r.random((seq_len + 1, rows)) < markov_order
    seq = np.empty((seq_len + 1, rows), dtype=np.int32)
    for t in range(seq_len + 1):
        tok = np.where(chain[t], perm[tok], noise[t])
        seq[t] = tok
    seq = torch.from_numpy(np.ascontiguousarray(seq.T)).to(device)
    seq = seq.view(count, batch, seq_len + 1)
    return [(seq[i, :, :seq_len].contiguous(), seq[i, :, 1:].contiguous())
            for i in range(count)]


# ---------------------------------------------------------------------------
# link capacities
# ---------------------------------------------------------------------------

def capacities(r: np.random.Generator, count: int, d: int,
               caps: dict) -> np.ndarray:
    """``count`` overlays of a newcomer and ``d`` providers, each directed
    link uniform on [lo, hi] blocks/s, no self links: (count, d+1, d+1)
    float64."""
    if caps.get("dist") != "uniform":
        raise ValueError(f"unknown capacity law {caps.get('dist')!r}")
    out = r.uniform(caps["lo"], caps["hi"], size=(count, d + 1, d + 1))
    idx = np.arange(d + 1)
    out[:, idx, idx] = 0.0
    return out


def sample_columns(r: np.random.Generator, width: int, count: int
                   ) -> np.ndarray:
    """``count`` distinct byte columns of ``width`` (all where fewer), the
    first and the last always among them, sorted."""
    if width <= count:
        return np.arange(width)
    pick = r.choice(width - 2, size=count - 2, replace=False) + 1
    return np.sort(np.concatenate([[0, width - 1], pick]))
