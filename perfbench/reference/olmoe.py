"""OLMoE's decoder (arXiv:2409.02060; allenai/OLMoE-1B-7B-0924) with one
device's share of every layer's experts, as plain PyTorch in float32: the
forward pass, the router's losses, the next-token loss and AdamW, for
judging the program's train step.  Imports nothing of the program (only
``reference/olmo.py``'s helpers); written from the published description
and the configuration file's sizes.

Per layer, with d = ``d_model``: h = x + Attn(RMSNorm(x)), then
out = h + MoE(RMSNorm(h)).  RMSNorm is weighted, epsilon ``norm_eps``.
Attn: q = RMSNorm_q(x Wq) and k = RMSNorm_k(x Wk), each norm over the
whole projected width before the split into heads; rotary embeddings
(half-split layout, theta from the configuration) on q and k; causal
softmax attention; the output projection.  MoE: p = softmax(x W_r) over
all ``router_experts`` experts; a token's top ``experts_per_token`` by p
(ties to the lower index), their p kept as they are; the layer's output
sum over the held experts e chosen by the token of
p_e * W2_e(silu(W1_e x) * W3_e x).  A final RMSNorm and the untied head.

The loss of a microbatch: the mean cross entropy over its labels, plus
``lb_weight`` times the load-balancing losses and ``z_weight`` times the
z-losses, each summed over the layers: E * sum_e f_e * P_e, f_e the
pairs the microbatch's tokens route to expert e over its token count
(no gradient) and P_e the mean of p_e over its tokens; the mean of
logsumexp(x W_r)^2 over its tokens.  A step's loss is the mean over its
microbatches (rows in order), its gradient the mean of theirs.

Departures from the published model, each the program's as well:
  * the share: only the experts ``expert_offset .. expert_offset +
    num_experts - 1`` are held, and the others' part of each layer's
    output is left out (it lies on other devices);
  * only the first ``num_layers`` layers are kept (the first pipeline
    stage), with the embedding, the final norm and the head.
How it is computed here and not in the program: every held expert runs
over every token of a sequence and is masked by its gate (no dispatch,
capacity or grouping), one sequence at a time; f_e, which the whole
microbatch sets, is taken in a forward pass without gradients first.
Weights are stored as the configuration states (bf16, the router fp32)
and upcast to float32; every product is float32 with TF32 off.
``precision="fp8"``: each product's operands rounded to float8 e4m3
(``olmo._RoundFP8``), the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.olmo import _RoundFP8, _rope, adamw_step, ieee_fp32


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def moe_share(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
              model: dict, mm=torch.matmul):
    """One layer's MoE over tokens x (S, d): (the held experts' part of the
    output, the router's logits and probabilities (S, E), the top-K ids
    (S, K), the chosen mask (S, E)).  Every held expert runs over every
    token, masked by its gate."""
    K, E = model["experts_per_token"], model["router_experts"]
    lo = model["expert_offset"]
    logits = mm(x, w[prefix + "router"])
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(logits.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :K]
    chosen = torch.zeros(x.shape[0], E, dtype=torch.bool, device=x.device)
    chosen.scatter_(1, top, True)
    y = torch.zeros_like(x)
    for j in range(model["num_experts"]):
        gate = torch.where(chosen[:, lo + j], probs[:, lo + j], 0.0)
        g = mm(x, w[prefix + "we_gate"][j])
        u = mm(x, w[prefix + "we_up"][j])
        y = y + gate[:, None] * mm(F.silu(g) * u, w[prefix + "we_down"][j])
    return y, logits, probs, top, chosen


def sequence_terms(w: Dict[str, torch.Tensor], model: dict,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   f: Optional[List[torch.Tensor]] = None,
                   precision: str = "fp32") -> dict:
    """One sequence (tokens, labels: (S,)): the summed cross entropy
    ``xent_sum``, and per layer the routing's pair counts over all
    experts ``counts`` (E,), the summed z-loss terms ``z_sum``, the summed
    probabilities ``p_sum`` (E,), and the held choices ``held`` (S, K),
    expert ids with -1 for the others.  With ``f`` (per layer (E,)),
    also ``lb`` per layer: E * sum_e f_e * p_sum_e (the sequence's part
    of the load-balancing loss, before the division by the tokens)."""
    q8 = _RoundFP8.apply if precision == "fp8" else (lambda t: t)

    def mm(a, b):
        return q8(a) @ q8(b)

    d, H, KV, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], model["head_dim"])
    E = model["router_experts"]
    lo, held = model["expert_offset"], model["num_experts"]
    eps = model["norm_eps"]
    s = tokens.shape[0]
    h = w["embed.tok"][tokens.long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = {"counts": [], "z_sum": [], "p_sum": [], "held": [], "lb": []}
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        x = _rms(h, w[p + "norm1.scale"], eps)
        q = _rms(mm(x, w[p + "attn.wq"].reshape(d, H * hd)),
                 w[p + "attn.q_norm"], eps).reshape(s, H, hd)
        k = _rms(mm(x, w[p + "attn.wk"].reshape(d, KV * hd)),
                 w[p + "attn.k_norm"], eps).reshape(s, KV, hd)
        v = mm(x, w[p + "attn.wv"].reshape(d, KV * hd)).reshape(s, KV, hd)
        q = _rope(q, model["rope_theta"]).transpose(0, 1)      # (H, S, D)
        k = _rope(k, model["rope_theta"]).transpose(0, 1)
        v = v.transpose(0, 1)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=0)
            v = v.repeat_interleave(H // KV, dim=0)
        scores = mm(q, k.transpose(1, 2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(scores, dim=-1), v)
        o = o.transpose(0, 1).reshape(s, H * hd)
        h = h + mm(o, w[p + "attn.wo"].reshape(H * hd, d))

        y, logits, probs, top, chosen = moe_share(
            _rms(h, w[p + "norm2.scale"], eps), w, p + "moe.", model, mm)
        h = h + y
        out["counts"].append(chosen.sum(0))
        out["z_sum"].append(torch.logsumexp(logits, dim=-1).square().sum())
        out["p_sum"].append(probs.sum(0))
        out["held"].append(torch.where((top >= lo) & (top < lo + held),
                                       top, -1))
        if f is not None:
            out["lb"].append(E * (f[i] * out["p_sum"][-1]).sum())
    logits = mm(_rms(h, w["final_norm.scale"], eps), w["embed.unembed"].t())
    keep = labels >= 0
    out["xent_sum"] = F.cross_entropy(logits[keep], labels[keep].long(),
                                      reduction="sum")
    return out


def loss_and_grads(params: Dict[str, torch.Tensor], model: dict,
                   tokens: torch.Tensor, labels: torch.Tensor, n_micro: int,
                   precision: str = "fp32"):
    """The step's loss (the mean of its microbatches'), its float32
    gradients, its loss parts (``xent``, ``lb_loss``, ``z_loss``: means
    over the microbatches, the router's summed over the layers) and the
    held choices of every layer and microbatch (``routes[layer][micro]``,
    (T, K) over the microbatch's rows in order)."""
    w = {n: p.detach().to(torch.float32, copy=True).requires_grad_(True)
         for n, p in params.items()}
    grads = {n: torch.zeros_like(t) for n, t in w.items()}
    L = model["num_layers"]
    parts = {"loss": 0.0, "xent": 0.0, "lb_loss": 0.0, "z_loss": 0.0}
    routes = [[] for _ in range(L)]
    rows = tokens.shape[0] // n_micro
    with ieee_fp32():
        for mb in range(n_micro):
            span = range(mb * rows, (mb + 1) * rows)
            T = sum(int(labels[r].numel()) for r in span)
            count = sum(int((labels[r] >= 0).sum()) for r in span)
            with torch.no_grad():       # f_e: the whole microbatch's
                firsts = [sequence_terms(w, model, tokens[r], labels[r],
                                         precision=precision) for r in span]
            f = [sum(o["counts"][i] for o in firsts).float() / T
                 for i in range(L)]
            for i in range(L):
                routes[i].append(torch.cat([o["held"][i] for o in firsts]))
            del firsts
            for r in span:
                o = sequence_terms(w, model, tokens[r], labels[r], f,
                                   precision)
                xent = o["xent_sum"] / count
                lb = sum(o["lb"]) / T
                z = sum(o["z_sum"]) / T
                loss = xent + model["lb_weight"] * lb \
                    + model["z_weight"] * z
                loss.backward()
                with torch.no_grad():
                    for key, val in (("loss", loss), ("xent", xent),
                                     ("lb_loss", lb), ("z_loss", z)):
                        parts[key] += float(val) / n_micro
                    for n, t in w.items():
                        if t.grad is not None:
                            grads[n] += t.grad
                            t.grad = None
                del o, loss
    for g in grads.values():
        g /= n_micro
    return parts, grads, routes


def train_steps(params: Dict[str, torch.Tensor], model: dict, opt: dict,
                batches: Sequence, n_micro: int,
                precision: str = "fp32") -> dict:
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
