"""DeepSeek-V2's decoder (arXiv:2405.04434; deepseek-ai/DeepSeek-V2-Lite)
with one device's share of every MoE layer's routed experts, as plain
PyTorch in float32: the forward pass, the balance loss, the next-token
loss and AdamW, for judging the program's train step.  Imports nothing of
the program (only ``reference/olmo.py``'s and ``reference/olmoe.py``'s
helpers); written from the paper, the published configuration and its
modeling code's equations, and the configuration file's sizes.

Per layer, with d = ``d_model`` and RMSNorm weighted at epsilon
``norm_eps``: h = x + MLA(RMSNorm(x)), then out = h + FFN(RMSNorm(h)).
MLA without query compression, H heads: q = x W_Q, each head [q_C; q_R]
of ``qk_nope_head_dim`` + ``qk_rope_head_dim``; [c; k_R] = x W_KVa, c of
``kv_lora_rank`` through its own RMSNorm; [k_C; v] = c W_KVb, each head
``qk_nope_head_dim`` + ``v_head_dim``; RoPE on q_R and the one k_R that
every head shares; q = [q_C; RoPE(q_R)], k = [k_C; RoPE(k_R)]; causal
softmax attention at the scale head_dim^-1/2 mscale(factor,
mscale_all_dim)^2; W_O.  RoPE: YaRN's frequencies (theta, the factor,
the original length, beta_fast and beta_slow of the configuration) and
cos, sin times mscale(factor, mscale) / mscale(factor, mscale_all_dim); the
pairs are the interleaved features (2i, 2i + 1), moved to [evens; odds]
before the half-split rotation, as the published code does.  The FFN of
the first ``first_dense`` layers: a SwiGLU of ``dense_d_ff``; of the
others, DeepSeekMoE: p = softmax(x W_r) over all ``router_experts``
experts, a token's top ``experts_per_token`` by p (ties to the lower
index), p kept as it is; the output the sum over the held experts e
chosen by the token of p_e SwiGLU_e(x), plus the shared experts, one
SwiGLU of ``shared_experts * d_ff``.  A final RMSNorm and the untied head.

The loss of a microbatch: the mean cross entropy over its labels, plus
``lb_weight`` times the balance loss summed over the MoE layers: the mean
over the microbatch's sequences of sum_e f_e P_e, f_e = E / (K S) times
e's choices among the sequence's S tokens (no gradient), P_e the mean of
p_e over them.  A step's loss is the mean over its microbatches (rows in
order), its gradient the mean of theirs.

Departures from the published model, each the program's as well:
  * the share: only the routed experts ``expert_offset .. expert_offset +
    num_experts - 1`` are held, and the others' part of each MoE layer's
    output is left out (it lies on other devices);
  * only the first ``num_layers`` layers are kept (the first pipeline
    stage), with the embedding, the final norm and the head;
  * the RoPE table and the rotation in float32 (the published code casts
    the table to the activations' dtype first), the routed and shared
    experts' outputs added in float32.
How it is computed here and not in the program: dense S x S scores; every
held expert runs over every token of a sequence and is masked by its
gate (no dispatch, capacity or grouping), one sequence at a time (a
sequence's balance term is its own).  Weights are stored as the
configuration states (bf16, the router fp32) and upcast to float32; every
product is float32 with TF32 off.  ``precision="fp8"``: each product's
operands rounded to float8 e4m3 (``olmo._RoundFP8``), the control.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.olmo import _RoundFP8, adamw_step, ieee_fp32
from perfbench.reference.olmoe import _rms, moe_share


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(model: dict) -> float:
    qk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    m = mscale(model["rope_factor"], model["mscale_all_dim"])
    return qk ** -0.5 * m * m


def yarn_cos_sin(model: dict, s: int, device):
    """cos and sin (s, 1, rope / 2) of YaRN's table at positions 0..s-1."""
    dim, base = model["qk_rope_head_dim"], model["rope_theta"]
    factor, original = model["rope_factor"], model["rope_original"]

    def correction(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(correction(model["beta_fast"])), 0)
    high = min(math.ceil(correction(model["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    exp = 2 * i / dim
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    inv = ramp / (factor * base ** exp) + (1 - ramp) / base ** exp
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    m = mscale(factor, model["mscale"]) / mscale(factor,
                                                 model["mscale_all_dim"])
    return (ang.cos() * m)[:, None], (ang.sin() * m)[:, None]


def _rope(x, cos, sin):
    """x (S, heads, R): the pairs (2i, 2i + 1) to [evens; odds], then the
    half-split rotation."""
    e, o = x[..., 0::2], x[..., 1::2]
    return torch.cat([e * cos - o * sin, o * cos + e * sin], dim=-1)


def _swiglu(x, w, prefix, mm):
    return mm(F.silu(mm(x, w[prefix + "w_gate"])) * mm(x, w[prefix + "w_up"]),
              w[prefix + "w_down"])


def sequence_terms(w: Dict[str, torch.Tensor], model: dict,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "fp32") -> dict:
    """One sequence (tokens, labels: (S,)): the summed cross entropy
    ``xent_sum``, and per MoE layer the sequence's balance term
    ``balance`` (sum_e f_e P_e) and its held choices ``held`` (S, K),
    expert ids with -1 for the others."""
    q8 = _RoundFP8.apply if precision == "fp8" else (lambda t: t)

    def mm(a, b):
        return q8(a) @ q8(b)

    d, H = model["d_model"], model["num_heads"]
    nope, rd = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, r = model["v_head_dim"], model["kv_lora_rank"]
    E, K = model["router_experts"], model["experts_per_token"]
    lo, held = model["expert_offset"], model["num_experts"]
    eps = model["norm_eps"]
    s = tokens.shape[0]
    scale = softmax_scale(model)
    cos, sin = yarn_cos_sin(model, s, tokens.device)
    h = w["embed.tok"][tokens.long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = {"balance": [], "held": []}
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        x = _rms(h, w[p + "norm1.scale"], eps)
        q = mm(x, w[p + "attn.wq"].reshape(d, H * (nope + rd))) \
            .reshape(s, H, nope + rd)
        kv_a = mm(x, w[p + "attn.wkv_a"])
        c = _rms(kv_a[:, :r], w[p + "attn.kv_norm"], eps)
        kv = mm(c, w[p + "attn.wkv_b"].reshape(r, H * (nope + dv))) \
            .reshape(s, H, nope + dv)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], -1)
        k_r = _rope(kv_a[:, None, r:], cos, sin).expand(s, H, rd)
        k = torch.cat([kv[..., :nope], k_r], -1).transpose(0, 1)
        v = kv[..., nope:].transpose(0, 1)                     # (H, S, dv)
        scores = mm(q.transpose(0, 1), k.transpose(1, 2)) * scale
        scores = scores.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(scores, dim=-1), v)
        o = o.transpose(0, 1).reshape(s, H * dv)
        h = h + mm(o, w[p + "attn.wo"].reshape(H * dv, d))
        x = _rms(h, w[p + "norm2.scale"], eps)
        if i < model["first_dense"]:
            h = h + _swiglu(x, w, p + "mlp.", mm)
            continue
        y, _, probs, top, chosen = moe_share(x, w, p + "moe.", model, mm)
        h = h + y + _swiglu(x, w, p + "moe.shared.", mm)
        f = chosen.sum(0).float() / (s * K / E)
        out["balance"].append((f * probs.mean(0)).sum())
        out["held"].append(torch.where((top >= lo) & (top < lo + held),
                                       top, -1))
    logits = mm(_rms(h, w["final_norm.scale"], eps), w["embed.unembed"].t())
    keep = labels >= 0
    out["xent_sum"] = F.cross_entropy(logits[keep], labels[keep].long(),
                                      reduction="sum")
    return out


def loss_and_grads(params: Dict[str, torch.Tensor], model: dict,
                   tokens: torch.Tensor, labels: torch.Tensor, n_micro: int,
                   precision: str = "fp32"):
    """The step's loss (the mean of its microbatches'), its float32
    gradients, its loss parts (``xent``, ``lb_loss`` (the balance loss
    summed over the MoE layers), ``z_loss`` (0): means over the
    microbatches) and the held choices of every MoE layer and microbatch
    (``routes[layer][micro]``, (T, K) over the microbatch's rows in
    order)."""
    w = {n: p.detach().to(torch.float32, copy=True).requires_grad_(True)
         for n, p in params.items()}
    grads = {n: torch.zeros_like(t) for n, t in w.items()}
    moe_layers = model["num_layers"] - model["first_dense"]
    parts = {"loss": 0.0, "xent": 0.0, "lb_loss": 0.0, "z_loss": 0.0}
    routes = [[] for _ in range(moe_layers)]
    rows = tokens.shape[0] // n_micro
    with ieee_fp32():
        for mb in range(n_micro):
            span = range(mb * rows, (mb + 1) * rows)
            count = sum(int((labels[r] >= 0).sum()) for r in span)
            held = [[] for _ in range(moe_layers)]
            for r in span:
                o = sequence_terms(w, model, tokens[r], labels[r], precision)
                xent = o["xent_sum"] / count
                lb = sum(o["balance"]) / rows
                loss = xent + model["lb_weight"] * lb
                loss.backward()
                with torch.no_grad():
                    for key, val in (("loss", loss), ("xent", xent),
                                     ("lb_loss", lb)):
                        parts[key] += float(val) / n_micro
                    for n, t in w.items():
                        if t.grad is not None:
                            grads[n] += t.grad
                            t.grad = None
                for i, x in enumerate(o["held"]):
                    held[i].append(x)
                del o, loss
            for i in range(moe_layers):
                routes[i].append(torch.cat(held[i]))
    for g in grads.values():
        g /= n_micro
    return parts, grads, routes


def train_steps(params: Dict[str, torch.Tensor], model: dict, opt: dict,
                batches: Sequence, n_micro: int, precision: str = "fp32"
                ) -> dict:
    """``len(batches)`` steps from ``params`` (updated in place).  Returns
    each step's loss and loss parts, the first step's clipped per-leaf
    gradient norms and held choices, and the per-leaf norms of the
    change over all the steps, in float32."""
    start = {n: p.float().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    losses, parts, first, routes = [], [], None, None
    for step, (tokens, labels) in enumerate(batches):
        got, grads, held = loss_and_grads(params, model, tokens, labels,
                                          n_micro, precision)
        losses.append(got["loss"])
        parts.append(got)
        norms = adamw_step(params, grads, m, v, step, opt)
        del grads
        if first is None:
            first, routes = norms, held
    change = [float(torch.linalg.vector_norm(p.float() - start[n]))
              for n, p in params.items()]
    return {"losses": losses, "parts": parts, "grad_norms": first,
            "change_norms": change, "routes": routes}
