"""Model assembly for all architecture families (the counterpart of
``repro.models.transformer``).

One block module per layer in a ``ModuleList``, applied in a Python loop
(the reference stacks the layers' parameters and scans them):

  * dense / vlm / audio : [norm -> GQA attention] + [norm -> SwiGLU]
  * moe                 : [norm -> GQA attention] + [norm -> top-k MoE]
  * ssm                 : [norm -> Mamba2/SSD]
  * hybrid (zamba2)     : the ssm stack; after every ``shared_attn_every``
                          layers one of ``num_shared_blocks`` weight-shared
                          attention blocks runs (application i uses block
                          i % num_shared_blocks)

Modality frontends are stubs, as in the reference: vlm takes precomputed
patch embeddings for the first ``num_frontend_tokens`` positions, audio
takes precomputed frame embeddings.

The entry points keep the reference's signatures, with the model module
in place of the parameter tree: ``loss_fn(cfg, model, batch)``,
``prefill(cfg, model, batch, cache)``, ``decode_step(cfg, model, cache,
tokens, pos)``.  Gradients are autograd's.  With ``cfg.remat``, a training
forward (no cache, autograd on) recomputes each layer's body in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
around the scanned body); ``remat_policy="dots"`` keeps the outputs of the
matmuls without batch dimensions instead of recomputing them (the
reference's ``dots_with_no_batch_dims_saveable``).  Remat changes memory,
not numbers.

Caches keep the reference's layout: attention k/v (L, B, S_max, KV, hd);
ssm conv (L, B, conv-1, di+2N) and state (L, B, Hs, P, N); hybrid adds the
shared-attention k/v (n_app, B, S_max, KV, hd), n_app = num_layers //
shared_attn_every.  Unlike the reference's functional update, the port
writes a cache in place and returns the same dict.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..distributed.hints import BATCH, hint
from .config import ModelConfig
from .layers import (MLP, Attention, Embed, Norm, chunked_softmax_xent, dt,
                     logits_last, param)
from .moe import MoE
from .ssd import SSD, apply_ssd, ssd_step

Index = Union[int, torch.Tensor]


class AttnBlock(nn.Module):
    """[norm1 -> attention] + [norm2 -> SwiGLU, or MoE for the moe family]."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 moe: bool = False):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        if moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, h, positions, cache=None, cache_index=None):
        # the residual stream's layout at the reference's seq_parallel
        # points: over (batch, sequence) with seq_parallel, else over the
        # batch (GSPMD infers the latter; DTensor would carry a partial sum
        # into the next norm)
        seq = "model" if self.attn.cfg.seq_parallel and cache is None else None
        h = hint(h, BATCH, seq, None)
        a_out, new_cache = self.attn(self.norm1(h), positions=positions,
                                     cache=cache, cache_index=cache_index)
        h = hint(h + a_out, BATCH, seq, None)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return hint(h + ffn(self.norm2(h)), BATCH, seq, None), new_cache


class SSDBlock(nn.Module):
    """[norm -> Mamba2/SSD] with a residual."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.norm = Norm(cfg, device)
        self.ssd = SSD(cfg, device)


class Transformer(nn.Module):
    """The parameters of one model, under the reference's names: ``blocks``
    (one entry per layer), ``embed``, ``final_norm``, and ``shared``
    (hybrid), ``patch_proj`` (vlm) or ``frame_proj`` (audio).  Built with
    uninitialised tensors; :func:`init_params` draws them.  ``allow_meta``
    lets the dry run's specs build it on ``"meta"`` (see
    :func:`~repro_torch.device.resolve_device`)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 allow_meta: bool = False):
        super().__init__()
        dev = resolve_device(device, allow_meta=allow_meta)
        self.cfg = cfg
        if cfg.family in ("dense", "vlm", "audio", "moe"):
            self.blocks = nn.ModuleList(
                AttnBlock(cfg, dev, moe=cfg.family == "moe")
                for _ in range(cfg.num_layers))
        elif cfg.family in ("ssm", "hybrid"):
            self.blocks = nn.ModuleList(SSDBlock(cfg, dev)
                                        for _ in range(cfg.num_layers))
        else:
            raise ValueError(cfg.family)
        self.embed = Embed(cfg, dev)
        self.final_norm = Norm(cfg, dev)
        if cfg.family == "hybrid":
            self.shared = nn.ModuleList(AttnBlock(cfg, dev)
                                        for _ in range(cfg.num_shared_blocks))
        if cfg.frontend == "patch_embed":
            self.patch_proj = param((cfg.d_model, cfg.d_model),
                                    dt(cfg, "param"), dev)
        if cfg.frontend == "frame_embed":
            self.frame_proj = param((cfg.d_model, cfg.d_model),
                                    dt(cfg, "param"), dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> Transformer:
    """A model of ``cfg`` with random weights on ``device`` (``cuda``
    unless ``"cpu"`` is named; raises without CUDA).

    The draws come from a ``torch.Generator`` on the device (``seed``, or
    the generator given): the reference's distributions (normals scaled by
    1/sqrt(fan-in), ones and zeros for norms and biases, the SSD's fixed
    A_log, D and dt_bias), not its bits, which come from threefry.  To hold
    the port to the reference, load the reference's weights with
    ``models.convert.from_reference_params``.
    """
    model = Transformer(cfg, device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "reset"):
                mod.reset(gen)
        for name in ("patch_proj", "frame_proj"):
            if hasattr(model, name):
                getattr(model, name).normal_(0.0, 1.0 / math.sqrt(cfg.d_model),
                                             generator=gen)
    return model


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, model: Transformer,
                 batch: Dict[str, Any]) -> torch.Tensor:
    c = dt(cfg)
    if cfg.frontend == "tokens":
        return model.embed.tokens(batch["tokens"])
    if cfg.frontend == "patch_embed":
        h = model.embed.tokens(batch["tokens"])
        pe = batch["patch_embeds"].to(c) @ model.patch_proj.to(c)
        n_img = pe.shape[1]
        return torch.cat([pe, h[:, n_img:]], dim=1)
    if cfg.frontend == "frame_embed":
        return batch["frames"].to(c) @ model.frame_proj.to(c)
    raise ValueError(cfg.frontend)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _shared_attn(cfg: ModelConfig, model: Transformer, h, positions,
                 app: int, cache, cache_index):
    """Hybrid: shared block ``app % num_shared_blocks`` with the cache slot
    of application ``app``."""
    blk = model.shared[app % cfg.num_shared_blocks]
    kv = None if cache is None else (cache["shared_k"][app],
                                     cache["shared_v"][app])
    h, _ = blk(h, positions, kv, cache_index)
    return h


def _ssd_layer(cfg: ModelConfig, blk: SSDBlock, h, cache, i: int):
    """One ssm layer; with a cache, a decode step (S == 1) or a prefill that
    leaves the layer's conv window and state in the cache."""
    x_in = blk.norm(h)
    if cache is None:
        return h + apply_ssd(cfg, blk.ssd, x_in)
    if h.shape[1] == 1:
        y, conv, state = ssd_step(cfg, blk.ssd, x_in, cache["conv"][i],
                                  cache["state"][i])
    else:
        y, (conv, state) = apply_ssd(cfg, blk.ssd, x_in, return_state=True)
    cache["conv"][i].copy_(conv)
    cache["state"][i].copy_(state)
    return h + y


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: keep the output of a matmul without batch
    dimensions (``mm``, ``addmm``, or a ``bmm`` of batch 1, which is how
    ``einsum`` runs a projection); recompute the rest."""
    if op in _MATMULS and (op != torch.ops.aten.bmm.default
                           or args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward (see the module
    docstring)."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def forward_hidden(cfg: ModelConfig, model: Transformer, h: torch.Tensor, *,
                   positions: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Optional[Index] = None,
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the blocks.  ``cache`` semantics:
      * None + cache_index None        -> training forward
      * cache buffers + cache_index    -> decode (or prefill seeding when the
        sequence is longer than one token and cache_index == 0)
    The cache is updated in place and returned."""
    fam = cfg.family
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    if fam in ("dense", "moe", "vlm", "audio"):
        for i, blk in enumerate(model.blocks):
            if remat:
                h = _remat(cfg, lambda x, b=blk: b(x, positions)[0], h)
            else:
                kv = None if cache is None else (cache["k"][i],
                                                 cache["v"][i])
                h, _ = blk(h, positions, kv, cache_index)
        return h, cache

    if fam in ("ssm", "hybrid"):
        every = cfg.shared_attn_every if fam == "hybrid" else 0
        for i, blk in enumerate(model.blocks):
            if remat:
                h = _remat(cfg, functools.partial(_ssd_layer, cfg, blk,
                                                  cache=None, i=i), h)
            else:
                h = _ssd_layer(cfg, blk, h, cache, i)
            if every and (i + 1) % every == 0:
                h = _shared_attn(cfg, model, h, positions, (i + 1) // every - 1,
                                 cache, cache_index)
        return h, cache

    raise ValueError(fam)


# ---------------------------------------------------------------------------
# public entry points (loss / prefill / decode)
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, model: Transformer, batch: Dict[str, Any]
            ) -> torch.Tensor:
    h = hint(embed_inputs(cfg, model, batch), BATCH, None, None)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    h, _ = forward_hidden(cfg, model, h, positions=positions)
    h = model.final_norm(h)
    return chunked_softmax_xent(cfg, model.embed, h, batch["labels"])


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None, *,
               allow_meta: bool = False) -> Dict[str, torch.Tensor]:
    """Zeroed cache buffers on ``device`` (``cuda`` unless ``"cpu"`` is
    named; ``"meta"`` with ``allow_meta``, for the dry run's specs)."""
    dev = resolve_device(device, allow_meta=allow_meta)
    L, B, S = cfg.num_layers, batch_size, max_len

    def zeros(shape, dt_=dtype):
        return torch.zeros(shape, dtype=dt_, device=dev)

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        kv = (L, B, S, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(kv), "v": zeros(kv)}
    di, N = cfg.d_inner, cfg.ssm_state
    cache = {
        "conv": zeros((L, B, cfg.ssm_conv - 1, di + 2 * N)),
        "state": zeros((L, B, cfg.ssm_heads, cfg.ssm_head_dim, N),
                       torch.float32),
    }
    if cfg.family == "hybrid":
        n_app = cfg.num_layers // cfg.shared_attn_every
        kv = (n_app, B, S, cfg.num_kv_heads, cfg.head_dim)
        cache["shared_k"] = zeros(kv)
        cache["shared_v"] = zeros(kv)
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Transformer, batch: Dict[str, Any],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the prompt, fill the cache, return last-position logits."""
    h = embed_inputs(cfg, model, batch)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    h, cache = forward_hidden(cfg, model, h, positions=positions, cache=cache,
                              cache_index=0)
    h = model.final_norm(h)
    return logits_last(cfg, model.embed, h), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: Index) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence in the batch.  tokens: (B, 1); ``pos``
    an int or a 0-d int32 tensor on the model's device.  Given a tensor,
    the step reads nothing on the host, so it can be captured once and
    replayed at every position (``serve.graph.DecodeGraph``); given an int,
    the cache is written through a slice, which DTensor caches (the dry
    run) need."""
    h = model.embed.tokens(tokens)
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=h.device).reshape(1)
    h, cache = forward_hidden(cfg, model, h, positions=positions,
                              cache=cache, cache_index=pos)
    h = model.final_norm(h)
    return logits_last(cfg, model.embed, h), cache
