"""Optimizers: AdamW and factored-second-moment Adafactor (the counterpart
of ``repro.train.optimizer``).

Dtype policy, as in the reference: AdamW with ``state_dtype`` moments and a
``grad_dtype`` gradient accumulator (fp32 by default); Adafactor (kimi-k2's
optimizer) keeps a factored second moment (O(r + c) state per (r, c)
matrix) in fp32 whatever ``state_dtype`` says, and no first moment with
``momentum=False``.  Every update runs in fp32 and is cast back to the
parameter's dtype.

The parameters are the model's own tensors (a ``Transformer``, or a
mapping of names to tensors), one per layer: ``apply_updates`` writes the
new values into them and into the moments in place.  Moments are
``OrderedDict``s keyed by parameter name.  DTensor parameters
(``distributed``) get DTensor moments placed like them; Adafactor's
factored moments and the step are replicated.

Adafactor factors the reference's *stacked* leaves.  The reference stacks
each layer's parameters along a leading axis, so a per-layer 1-D leaf
(a norm scale, mamba2's ``A_log``, ...) is a 2-D leaf there, factored
across layers: ``row`` holds one value a layer, ``col`` one a feature.
So the leaves ``blocks.<i>.X`` (and ``shared.<i>.X``) of rank 1 are
grouped under the key ``blocks.X``, and their state has the reference's
shapes: ``row`` (L,), ``col`` (d,).  A per-layer leaf of rank >= 2 is
factored on its own: in the stacked leaf the layer axis is a batch axis,
so the arithmetic is the same.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, List, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..distributed.hints import replicate_like
from ..ft.erasure import tree_flatten
from ..models.convert import _STACKED
from ..models.layers import _DTYPES


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    mode: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    grad_dtype: str = "float32"  # gradient-accumulator dtype
    momentum: bool = True        # adafactor: keep first moment?


# backwards-compatible alias, as in the reference
AdamWConfig = OptimizerConfig


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any          # first moment (or () when disabled)
    v: Any          # adamw: full second moment; adafactor: {row, col} or {full}


AdamWState = OptState

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named_params(params: Params) -> "collections.OrderedDict[str, torch.Tensor]":
    """The parameters by name: a module's ``named_parameters()``, or the
    mapping given."""
    if isinstance(params, nn.Module):
        return collections.OrderedDict(params.named_parameters())
    return collections.OrderedDict(params)


def factor_groups(named: Mapping[str, torch.Tensor]
                  ) -> List[Tuple[str, List[str], bool]]:
    """Adafactor's state keys: (key, parameter names, stacked).  Per-layer
    rank-1 leaves ``blocks.<i>.X`` / ``shared.<i>.X`` form one stacked
    group ``blocks.X`` (layers in order); every other leaf is its own."""
    groups: "collections.OrderedDict[str, Tuple[List[str], bool]]" = \
        collections.OrderedDict()
    for name, p in named.items():
        top, *rest = name.split(".", 2)
        if top in _STACKED and len(rest) == 2 and p.dim() == 1:
            groups.setdefault(f"{top}.{rest[1]}", ([], True))[0].append(name)
        else:
            groups[name] = ([name], False)
    return [(key, names, stacked) for key, (names, stacked) in groups.items()]


def init_opt(cfg: OptimizerConfig, params: Params,
             device: DeviceLike = None) -> OptState:
    """Zeroed state for ``params`` on ``device`` (``cuda`` unless ``"cpu"``
    is named; raises without CUDA)."""
    dev = resolve_device(device)
    named = named_params(params)
    sdt = _DTYPES[cfg.state_dtype]

    ref = next(iter(named.values()))

    def zeros(shape, dtype=sdt):
        return replicate_like(ref, torch.zeros(shape, dtype=dtype, device=dev))

    def moment(p):
        if isinstance(p, DTensor):      # sharded like its parameter
            return torch.zeros_like(p, dtype=sdt)
        return torch.zeros(p.shape, dtype=sdt, device=dev)

    def moments():
        return collections.OrderedDict((n, moment(p))
                                       for n, p in named.items())

    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.mode == "adamw":
        return OptState(step=step, m=moments(), v=moments())
    v = collections.OrderedDict()
    for key, names, stacked in factor_groups(named):
        shape = ((len(names),) + tuple(named[names[0]].shape) if stacked
                 else tuple(named[key].shape))
        if len(shape) < 2:
            v[key] = {"full": zeros(shape, torch.float32)}
        else:
            v[key] = {"row": zeros(shape[:-1], torch.float32),
                      "col": zeros(shape[:-2] + shape[-1:], torch.float32)}
    return OptState(step=step, m=moments() if cfg.momentum else (), v=v)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_flatten(tree)[0]))


def _step_param(p: torch.Tensor, delta: torch.Tensor, lr) -> None:
    p.copy_((p.float() - lr * delta).to(p.dtype))


def _adamw_update(cfg, named, grads, state, lr, clip) -> None:
    t = (state.step + 1).float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in named.items():
        g = grads[name].float() * clip
        m, v = state.m[name], state.v[name]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + \
            cfg.weight_decay * p.float()
        _step_param(p, delta, lr)
        m.copy_(m32)
        v.copy_(v32)


def _adafactor_update(cfg, named, grads, state, lr, clip) -> None:
    d = 1.0 - cfg.b2  # decay toward running means
    for key, names, stacked in factor_groups(named):
        if stacked:
            g32 = torch.stack([grads[n].float() for n in names]) * clip
        else:
            g32 = grads[key].float() * clip
        v = state.v[key]
        if "full" in v:
            full = cfg.b2 * v["full"] + d * g32 * g32
            u = g32 / (torch.sqrt(full) + cfg.eps)
            v["full"].copy_(full)
        else:
            row = cfg.b2 * v["row"] + d * torch.mean(g32 * g32, dim=-1)
            col = cfg.b2 * v["col"] + d * torch.mean(g32 * g32, dim=-2)
            # rank-1 reconstruction of the second moment
            denom = torch.sqrt(
                row[..., None] * col[..., None, :]
                / (torch.mean(row, dim=-1)[..., None, None] + 1e-30)) + cfg.eps
            u = g32 / denom
            v["row"].copy_(row)
            v["col"].copy_(col)
        for i, name in enumerate(names):
            p, ui = named[name], (u[i] if stacked else u)
            if cfg.momentum:
                m = state.m[name]
                ui = cfg.b1 * m.float() + (1 - cfg.b1) * ui
                m.copy_(ui)
            _step_param(p, ui + cfg.weight_decay * p.float(), lr)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Params,
                  grads: Mapping[str, torch.Tensor], state: OptState,
                  lr_scale: "torch.Tensor | float" = 1.0
                  ) -> Tuple[Params, OptState]:
    """One optimizer step.  ``grads`` maps each parameter's name to its
    gradient.  The parameters and the moments are updated in place; returns
    ``(params, state)`` with the state's step advanced."""
    named = named_params(params)
    gnorm = global_norm([grads[n] for n in named])
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * lr_scale
    if cfg.mode == "adamw":
        _adamw_update(cfg, named, grads, state, lr, clip)
    else:
        _adafactor_update(cfg, named, grads, state, lr, clip)
    return params, OptState(step=state.step + 1, m=state.m, v=state.v)
