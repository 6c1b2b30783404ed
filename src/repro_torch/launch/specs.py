"""Abstract inputs per (architecture x shape cell) for the dry run (the
counterpart of ``repro.launch.specs``).

Everything here is a ``meta`` tensor: the reference's shapes and dtypes,
no data, no device memory.  ``params_specs`` is the port's model built on
``meta``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device
from ..models import Transformer, init_cache
from ..models.config import ModelConfig, ShapeConfig

# train_4k gradient-accumulation microbatch count per arch (memory knob;
# per-microbatch rows = global_batch / n_micro)
TRAIN_MICROBATCHES = {
    "olmo-1b": 4, "qwen1.5-0.5b": 4, "mamba2-370m": 4, "hubert-xlarge": 4,
    "yi-6b": 8, "olmoe-1b-7b": 8,
    "qwen2.5-14b": 16, "pixtral-12b": 16, "zamba2-7b": 16,
    "kimi-k2-1t-a32b": 32,
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype,
                       device=resolve_device("meta", allow_meta=True))


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend in ("tokens", "patch_embed"):
        out["tokens"] = _meta((batch, seq), torch.int32)
        if cfg.frontend == "patch_embed":
            out["patch_embeds"] = _meta(
                (batch, cfg.num_frontend_tokens, cfg.d_model), torch.bfloat16)
    else:  # frame_embed
        out["frames"] = _meta((batch, seq, cfg.d_model), torch.bfloat16)
    if with_labels:
        out["labels"] = _meta((batch, seq), torch.int32)
    return out


def params_specs(cfg: ModelConfig) -> Transformer:
    return Transformer(cfg, "meta", allow_meta=True)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, torch.Tensor]:
    return init_cache(cfg, batch, max_len, dtype=torch.bfloat16,
                      device="meta", allow_meta=True)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All abstract inputs for the cell's step function."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"params": params_specs(cfg),
                "batch": batch_specs(cfg, B, S)}
    if shape.kind == "prefill":
        specs = {"params": params_specs(cfg),
                 "batch": batch_specs(cfg, B, S, with_labels=False)}
        if not cfg.is_encoder_only:
            specs["cache"] = cache_specs(cfg, B, S)
        return specs
    if shape.kind == "decode":
        return {"params": params_specs(cfg),
                "cache": cache_specs(cfg, B, S),
                "tokens": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)
