"""Train / serve step functions (the counterpart of ``repro.train.step``).

``make_train_step``: gradient-accumulation microbatching (a loop over
microbatches, a ``grad_dtype`` accumulator), the optimizer step, and the
metrics.  The microbatch count is a memory knob: activations live only for
one microbatch.  Gradients are autograd's; each parameter's ``.grad`` is
freed as soon as it has been added to the accumulator.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models import decode_step as model_decode
from ..models import loss_fn as model_loss
from ..models import prefill as model_prefill
from ..models.config import ModelConfig
from ..models.layers import _DTYPES
from .optimizer import (AdamWConfig, AdamWState, apply_updates, global_norm,
                        named_params)


def _split_microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    def r(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             f"microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_micro)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    grad_shardings: Any = None,
                    gather_weights_once: bool = False) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss of each microbatch, its backward, the gradients
    summed in a ``grad_dtype`` accumulator as ``(a + g.to(gdt)).to(gdt)``,
    divided by ``n_micro`` in fp32, then ``apply_updates`` (in place).
    Metrics: ``loss`` (mean over microbatches), ``grad_norm`` (of the
    averaged gradients) and ``step``, as 0-d tensors on the model's device.

    ``grad_shardings`` and ``gather_weights_once`` place gradients and
    weights on a mesh; sharding is not ported yet, so they raise."""
    if grad_shardings is not None or gather_weights_once:
        raise NotImplementedError("grad_shardings and gather_weights_once "
                                  "need sharding, which the port lacks")
    gdt = _DTYPES[opt_cfg.grad_dtype]

    def train_step(model, opt_state: AdamWState, batch):
        params = named_params(model)
        acc = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
               for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
        with torch.enable_grad():
            for mb in _split_microbatches(batch, n_micro):
                loss = model_loss(cfg, model, mb)
                loss.backward()
                with torch.no_grad():
                    for n, p in params.items():
                        acc[n].add_(p.grad.to(gdt))
                        p.grad = None
                loss_sum = loss_sum + loss.detach()
                del loss
        grads = {n: a.float().div_(n_micro) for n, a in acc.items()}
        del acc
        model, new_opt = apply_updates(opt_cfg, model, grads, opt_state)
        metrics = {"loss": loss_sum / n_micro,
                   "grad_norm": global_norm([grads[n] for n in params]),
                   "step": new_opt.step}
        return model, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch, cache):
        return model_prefill(cfg, model, batch, cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(model, cache, tokens, pos):
        return model_decode(cfg, model, cache, tokens, pos)
    return decode_step
