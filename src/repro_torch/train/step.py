"""Train / serve step functions (the counterpart of ``repro.train.step``).

``make_train_step``: gradient-accumulation microbatching (a loop over
microbatches, a ``grad_dtype`` accumulator), the optimizer step, and the
metrics.  The microbatch count is a memory knob: activations live only for
one microbatch.  Gradients are autograd's; each parameter's ``.grad`` is
freed as soon as it has been added to the accumulator.  With DTensor
parameters (``distributed``) the same loop runs through DTensor's sharding
propagation; ``grad_shardings`` and ``gather_weights_once`` are the
reference's layout controls, as redistributions.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from ..models import decode_step as model_decode
from ..models import loss_fn as model_loss
from ..models import prefill as model_prefill
from ..models.config import ModelConfig
from ..models.layers import _DTYPES
from .optimizer import (AdamWConfig, AdamWState, apply_updates, global_norm,
                        named_params)


def _split_microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """The microbatches: consecutive rows of the batch.  A DTensor batch
    is split on each device's own rows (microbatch i takes the i-th block
    of every device's shard), so a microbatch stays sharded like the
    batch; on a 1x1 mesh this is the plain split."""
    if n_micro == 1:
        return [batch]

    def r(x):
        local = x.to_local() if isinstance(x, DTensor) else x
        b = local.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             f"microbatches" + (" on a device's shard"
                             if isinstance(x, DTensor) else ""))
        parts = local.reshape(n_micro, b // n_micro, *local.shape[1:])
        if not isinstance(x, DTensor):
            return parts
        shape = torch.Size((x.shape[0] // n_micro,) + tuple(x.shape[1:]))
        stride = torch.empty(shape, device="meta").stride()
        return [DTensor.from_local(part, x.device_mesh, x.placements,
                                   run_check=False, shape=shape,
                                   stride=stride) for part in parts]
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_micro)]


def _drop_axis(mesh, placements: tuple, axis: str) -> tuple:
    """``placements`` with mesh axis ``axis`` replicated (the layout of a
    weight gathered once over it)."""
    return tuple(Replicate() if name == axis else pl
                 for name, pl in zip(mesh.mesh_dim_names, placements))


@contextlib.contextmanager
def _swapped(model, tensors: Dict[str, torch.Tensor]):
    """The model's parameters replaced by ``tensors`` (by name) while the
    block runs."""
    saved = {}
    for name, t in tensors.items():
        prefix, _, leaf = name.rpartition(".")
        mod = model.get_submodule(prefix)
        saved[name] = (mod, leaf, mod._parameters[leaf])
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in saved.values():
            mod._parameters[leaf] = p


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    grad_shardings: Any = None,
                    gather_weights_once: bool = False) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss of each microbatch, its backward, the gradients
    summed in a ``grad_dtype`` accumulator as ``(a + g.to(gdt)).to(gdt)``,
    divided by ``n_micro`` in fp32, then ``apply_updates`` (in place).
    Metrics: ``loss`` (mean over microbatches), ``grad_norm`` (of the
    averaged gradients) and ``step``, as plain 0-d tensors on the model's
    device.

    ``grad_shardings``: {parameter name: placements} (``distributed.
    param_shardings``) for a model whose parameters are DTensors.  Each
    micro-gradient and the accumulator are redistributed to their
    parameter's placements before they are added (without it a gradient
    may come back replicated, a parameter-sized buffer on every device).

    ``gather_weights_once`` (with ``grad_shardings``): the weights are
    redistributed with "data" replicated once before the microbatch loop
    (one gather a step instead of one a layer and microbatch), the
    micro-gradients accumulate in that layout with no collective per
    microbatch, and the sum is redistributed to the 2-D layout once after
    the loop."""
    gdt = _DTYPES[opt_cfg.grad_dtype]

    def train_step(model, opt_state: AdamWState, batch):
        params = named_params(model)
        if grad_shardings is not None:
            missing = [n for n, p in params.items()
                       if n not in grad_shardings or not isinstance(p, DTensor)]
            if missing:
                raise TypeError(f"grad_shardings needs a DTensor parameter "
                                f"and its placements for every name; not "
                                f"for {missing[:3]}")
        gather = gather_weights_once and grad_shardings is not None
        compute = params
        if gather:      # one gather over "data" a step, out of autograd
            compute = {n: nn.Parameter(p.detach().redistribute(
                p.device_mesh, _drop_axis(p.device_mesh, grad_shardings[n],
                                          "data")))
                       for n, p in params.items()}
            acc = {}    # partial sums over "data": no collective a micro
        elif grad_shardings is not None:
            acc = {n: torch.zeros_like(p, dtype=gdt)
                   for n, p in params.items()}
        else:
            acc = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                   for n, p in params.items()}

        def constrain(g, name):
            if grad_shardings is None or \
                    tuple(g.placements) == grad_shardings[name]:
                return g
            return g.redistribute(g.device_mesh, grad_shardings[name])

        loss_sum = None
        with torch.enable_grad(), (_swapped(model, compute) if gather
                                   else contextlib.nullcontext()):
            for mb in _split_microbatches(batch, n_micro):
                loss = model_loss(cfg, model, mb)
                loss.backward()
                with torch.no_grad():
                    for n, p in compute.items():
                        if not gather:
                            acc[n].add_(constrain(p.grad, n).to(gdt))
                        elif n in acc:
                            acc[n] = (acc[n] + p.grad.to(gdt)).to(gdt)
                        else:
                            acc[n] = p.grad.to(gdt)
                        p.grad = None
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                del loss
        # the update reads gradients in the parameters' layout
        grads = {n: constrain(a.float().div_(n_micro), n)
                 for n, a in acc.items()}
        del acc, compute
        model, new_opt = apply_updates(opt_cfg, model, grads, opt_state)
        gnorm = global_norm([grads[n] for n in params])
        loss = loss_sum / n_micro
        metrics = {"loss": _plain(loss), "grad_norm": _plain(gnorm),
                   "step": new_opt.step}
        return model, new_opt, metrics

    return train_step


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch, cache):
        return model_prefill(cfg, model, batch, cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(model, cache, tokens, pos):
        return model_decode(cfg, model, cache, tokens, pos)
    return decode_step
