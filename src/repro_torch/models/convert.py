"""Carry model weights between the reference and the port.

The reference keeps a model as a nested dict of arrays whose ``blocks``
(and, for hybrid, ``shared``) leaves are stacked along a leading layer
axis; the port keeps one module per layer under the same names, so
``blocks/attn/wq`` of shape (L, d, H, hd) becomes ``blocks.<i>.attn.wq`` of
shape (d, H, hd).  Both directions move bit patterns: a bf16 leaf is
carried as its 16-bit words, so nothing is rounded on the way (numpy has
no bf16 of its own; the reference's arrays carry the ``bfloat16`` dtype of
``ml_dtypes``, which the port does not import).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from .config import ModelConfig
from .transformer import Transformer

_STACKED = ("blocks", "shared")


def _walk(tree: Dict[str, Any], prefix: str = ""
          ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _to_tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_reference_params(cfg: ModelConfig, tree: Dict[str, Any],
                          device: DeviceLike = None) -> Transformer:
    """The port's model holding the reference's parameters ``tree`` (a
    nested dict of numpy arrays, or of anything ``np.asarray`` takes), on
    ``device`` (``cuda`` unless ``"cpu"`` is named).  Every tensor of the
    model must be given, with its shape and dtype."""
    flat = {}
    for name, arr in _walk(tree):
        t = _to_tensor(arr)
        top = name.split(".", 1)
        if top[0] in _STACKED:
            for i in range(t.shape[0]):
                flat[f"{top[0]}.{i}.{top[1]}"] = t[i]
        else:
            flat[name] = t
    model = Transformer(cfg, device)
    own = model.state_dict()
    if set(own) != set(flat):
        raise ValueError(f"parameter names differ: only in the model "
                         f"{sorted(set(own) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, t in flat.items():
            if own[name].shape != t.shape or own[name].dtype != t.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} given, "
                                 f"{tuple(own[name].shape)} "
                                 f"{own[name].dtype} wanted")
            own[name].copy_(t)
    return model


def to_reference_params(model: Transformer) -> Dict[str, Any]:
    """The reference's nested dict of numpy arrays for ``model``: the
    inverse of :func:`from_reference_params`.  bf16 tensors come back as
    their uint16 bit patterns (view them as the reference's
    ``jnp.bfloat16``)."""
    groups: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    tree: Dict[str, Any] = {}

    def put(node: Dict[str, Any], path, arr) -> None:
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16).copy()
        else:
            arr = t.numpy().copy()
        path = name.split(".")
        if path[0] in _STACKED:
            groups.setdefault(path[0], {}).setdefault(int(path[1]), {})[
                ".".join(path[2:])] = arr
        else:
            put(tree, path, arr)
    for top, layers in groups.items():
        for leaf in layers[0]:
            put(tree, [top, *leaf.split(".")],
                np.stack([layers[i][leaf] for i in range(len(layers))]))
    # parameterless norms (nonparam_ln) are empty dicts in the reference
    cfg = model.cfg
    if cfg.norm == "nonparam_ln":
        tree.setdefault("final_norm", {})
        for top in _STACKED:
            for key in _norm_keys(cfg, top) if top in tree else ():
                tree[top].setdefault(key, {})
    return tree


def _norm_keys(cfg: ModelConfig, top: str) -> Tuple[str, ...]:
    if top == "blocks" and cfg.family in ("ssm", "hybrid"):
        return ("norm",)
    return ("norm1", "norm2")
