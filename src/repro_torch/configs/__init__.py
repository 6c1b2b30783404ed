"""Assigned-architecture registry: ``get_config(name)`` / ``get_smoke_config``
(a copy of ``repro.configs``; the arch modules are dimensions only).

Each module defines ``full_config()`` (the exact published shape) and
``smoke_config()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig

ARCH_IDS = [
    "zamba2-7b",
    "mamba2-370m",
    "olmo-1b",
    "qwen2.5-14b",
    "yi-6b",
    "qwen1.5-0.5b",
    "kimi-k2-1t-a32b",
    "olmoe-1b-7b",
    "pixtral-12b",
    "hubert-xlarge",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).full_config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def shape_cells(name: str) -> List[str]:
    """The runnable shape cells for an arch; skips per DESIGN.md §4."""
    cfg = get_config(name)
    cells = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        cells.append("decode_32k")
        if cfg.sub_quadratic:
            cells.append("long_500k")
    return cells


def skipped_cells(name: str) -> Dict[str, str]:
    cfg = get_config(name)
    skips = {}
    if cfg.is_encoder_only:
        skips["decode_32k"] = "encoder-only: no autoregressive decode step"
        skips["long_500k"] = "encoder-only: no decode; full attention is O(L^2)"
    elif not cfg.sub_quadratic:
        skips["long_500k"] = "pure full-attention arch: not sub-quadratic"
    return skips
