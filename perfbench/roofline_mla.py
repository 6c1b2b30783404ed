"""The FLOPs of a train step of a share of DeepSeek-V2 (MLA, a leading
dense layer, DeepSeekMoE with shared experts), and the least time of its
attention calls, from shapes and counted pairs alone (the peaks are
``roofline.PEAKS``)."""
from __future__ import annotations


def mla_matmul_params(model: dict) -> int:
    """One layer's MLA projections: W_Q, W_KVa, W_KVb and W_O (the latent
    norm's scale enters no product)."""
    d, H = model["d_model"], model["num_heads"]
    r, rd = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    return d * H * (nope + rd) + d * (r + rd) + r * H * (nope + dv) \
        + H * dv * d


def dense_matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product once a token: every layer's
    MLA projections, the leading dense layers' SwiGLU, each MoE layer's
    router (at its full width) and shared experts, and the untied head
    (the token embedding is a lookup)."""
    d, f, L = model["d_model"], model["d_ff"], model["num_layers"]
    dense = model["first_dense"]
    moe = d * model["router_experts"] + 3 * d * model["shared_experts"] * f
    return L * mla_matmul_params(model) + dense * 3 * d * model["dense_d_ff"] \
        + (L - dense) * moe + model["vocab_size"] * d


def attention_flops(B: int, S: int, H: int, qk_dim: int, v_dim: int,
                    causal: bool = True):
    """(forward, backward) FLOPs of attention over B x H sequences of S:
    2 multiply-adds' worth a (query, key) pair and feature, over the pairs
    the mask keeps (S (S + 1) / 2 causal); the forward's QK^T at
    ``qk_dim`` and PV at ``v_dim``, the backward's dQ and dK at ``qk_dim``
    and dP and dV at ``v_dim`` (the scores recomputed are not counted)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    unit = 2 * B * H * pairs
    return unit * (qk_dim + v_dim), unit * 2 * (qk_dim + v_dim)


def train_step_flops(model: dict, tokens: int, seq_len: int,
                     pairs: float) -> float:
    """A train step's model FLOPs: 6 N T over the dense products, 6 times
    the SwiGLU's 3 d f a (token, held expert) pair over the ``pairs``
    counted in the step (all MoE layers), and causal attention's
    3 L S H (d_qk + d_v) a token (QK^T and PV at their widths, forward and
    backward, half the square).  Remat's recomputation is not counted: it
    is not the model's work."""
    d, f, H, L = (model["d_model"], model["d_ff"], model["num_heads"],
                  model["num_layers"])
    qk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    return (6 * dense_matmul_params(model) * tokens
            + 6 * 3 * d * f * pairs
            + 3 * L * seq_len * H * (qk + model["v_head_dim"]) * tokens)


def attention_bound_s(model: dict, rows: int, seq_len: int, calls: int,
                      passes: int, pk: dict) -> float:
    """Least time of ``calls`` attention calls (layers x microbatches) of
    ``rows`` sequences of ``seq_len`` each, each call's forward run
    ``passes`` times (2 under remat: the forward and its recomputation)
    and its backward once: :func:`attention_flops` against the bf16 peak,
    or the bytes (q, k, v read and the output written in bf16 each pass;
    the backward reads q, k, v, the output's gradient and writes dq, dk,
    dv) against the HBM bandwidth, whichever is larger.  From the shapes
    alone, so it is the same work whatever kernel computes it."""
    H = model["num_heads"]
    qk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    dv = model["v_head_dim"]
    fwd, bwd = attention_flops(rows, seq_len, H, qk, dv)
    flops = calls * (passes * fwd + bwd)
    tokens = rows * seq_len * H
    elems = calls * tokens * (passes * (2 * qk + 2 * dv)
                              + 2 * (2 * qk + 2 * dv))
    return max(flops / pk["bf16_flops"], 2 * elems / pk["hbm_bytes_per_s"])
