"""OLMo's decoder (arXiv:2402.00838) as plain PyTorch in float32: the
forward pass, the next-token loss and AdamW, for judging the program's
train step.  Imports nothing of the program; written from the published
description and the configuration file's sizes.

Per layer: a non-parametric LayerNorm (eps 1e-5), multi-head causal
attention with rotary embeddings (half-split layout, theta from the
configuration), the residual, a second LayerNorm, a SwiGLU MLP
(silu(x W_gate) * (x W_up)) W_down, the residual.  A final LayerNorm and
the output head (the token embedding where the configuration ties them);
the loss is the mean cross entropy over every label >= 0.  Weights are stored as the configuration states (bf16) and
upcast to float32; every product is float32 with TF32 off.

``precision="fp8"`` is the control: each product's operands are rounded
to float8 e4m3 (one scale a tensor, from its largest magnitude) in the
forward, the gradients passing straight through.  It stands for the
nearest precision below the bf16 that the configuration states.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for matmuls and convolutions while the block runs."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    was = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, w in zip(flags, was):
            f.allow_tf32 = w


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5)


def _rope(x, theta):
    """x (S, H, D): the first D/2 features pair with the last D/2."""
    s, _, d = x.shape
    freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sequence_loss_sum(w: Dict[str, torch.Tensor], model: dict,
                      tokens: torch.Tensor, labels: torch.Tensor,
                      precision: str = "fp32") -> torch.Tensor:
    """The summed cross entropy of one sequence (tokens, labels: (S,))."""
    q8 = _RoundFP8.apply if precision == "fp8" else (lambda t: t)

    def mm(a, b):
        return q8(a) @ q8(b)

    d, H, hd = model["d_model"], model["num_heads"], model["head_dim"]
    s = tokens.shape[0]
    h = w["embed.tok"][tokens.long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        x = _ln(h)
        q = mm(x, w[p + "attn.wq"].reshape(d, H * hd)).reshape(s, H, hd)
        k = mm(x, w[p + "attn.wk"].reshape(d, H * hd)).reshape(s, H, hd)
        v = mm(x, w[p + "attn.wv"].reshape(d, H * hd)).reshape(s, H, hd)
        q = _rope(q, model["rope_theta"]).transpose(0, 1)      # (H, S, D)
        k = _rope(k, model["rope_theta"]).transpose(0, 1)
        v = v.transpose(0, 1)
        scores = mm(q, k.transpose(1, 2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(scores, dim=-1), v)                # (H, S, D)
        o = o.transpose(0, 1).reshape(s, H * hd)
        h = h + mm(o, w[p + "attn.wo"].reshape(H * hd, d))
        x = _ln(h)
        g = mm(x, w[p + "mlp.w_gate"])
        u = mm(x, w[p + "mlp.w_up"])
        h = h + mm(F.silu(g) * u, w[p + "mlp.w_down"])
    head = w["embed.tok"] if model.get("tie_embeddings", False) \
        else w["embed.unembed"]
    logits = mm(_ln(h), head.t())
    keep = labels >= 0
    return F.cross_entropy(logits[keep], labels[keep].long(),
                           reduction="sum")


def loss_and_grads(params: Dict[str, torch.Tensor], model: dict,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "fp32"):
    """Mean loss over the batch's labels and its float32 gradients, one
    sequence at a time (the gradients summed, then divided by the count)."""
    w = {n: p.detach().to(torch.float32, copy=True).requires_grad_(True)
         for n, p in params.items()}
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    count = int((labels >= 0).sum())
    grads = {n: torch.zeros_like(t) for n, t in w.items()}
    with ieee_fp32():
        for row in range(tokens.shape[0]):
            loss = sequence_loss_sum(w, model, tokens[row], labels[row],
                                     precision)
            loss.backward()
            with torch.no_grad():
                total += loss.detach()
                for n, t in w.items():
                    if t.grad is not None:
                        grads[n] += t.grad
                        t.grad = None
    for g in grads.values():
        g /= count
    return total / count, grads


def adamw_step(params: Dict[str, torch.Tensor], grads, m, v, step: int,
               opt: dict) -> List[float]:
    """One AdamW step in place: the global norm clipped to ``grad_clip``,
    bias-corrected moments (float32), decoupled weight decay, the new
    values rounded to the parameters' stored dtype.  Returns the clipped
    gradients' per-leaf norms, in ``params``' order."""
    b1, b2 = opt["b1"], opt["b2"]
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    clip = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    norms = []
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n] * clip
            norms.append(float(torch.linalg.vector_norm(g)))
            m[n].mul_(b1).add_((1 - b1) * g)
            v[n].mul_(b2).add_((1 - b2) * g * g)
            delta = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"]) \
                + opt["weight_decay"] * p.float()
            p.copy_((p.float() - opt["lr"] * delta).to(p.dtype))
    return norms


def train_steps(params: Dict[str, torch.Tensor], model: dict, opt: dict,
                batches: Sequence, precision: str = "fp32") -> dict:
    """``len(batches)`` steps from ``params`` (updated in place).  Returns
    each step's loss, the first step's clipped per-leaf gradient norms, and
    the per-leaf norms of the change over all the steps, in float32."""
    start = {n: p.float().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches):
        loss, grads = loss_and_grads(params, model, tokens, labels, precision)
        losses.append(float(loss))
        norms = adamw_step(params, grads, m, v, step, opt)
        del grads
        if first is None:
            first = norms
    change = [float(torch.linalg.vector_norm(p.float() - start[n]))
              for n, p in params.items()]
    return {"losses": losses, "grad_norms": first, "change_norms": change}
