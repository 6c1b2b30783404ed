"""The FLOPs of a train step of an expert share of OLMoE, and the least
time of its grouped expert products, from shapes and counted pairs alone
(the peaks are ``roofline.PEAKS``)."""
from __future__ import annotations


def dense_matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product once a token: per layer the
    four attention projections and the router (at its full width), and
    the untied head (the token embedding is a lookup)."""
    d, H, KV, hd, V, L = (model["d_model"], model["num_heads"],
                          model["num_kv_heads"], model["head_dim"],
                          model["vocab_size"], model["num_layers"])
    return L * (2 * d * H * hd + 2 * d * KV * hd
                + d * model["router_experts"]) + V * d


def train_step_flops(model: dict, tokens: int, seq_len: int,
                     pairs: float) -> float:
    """A train step's model FLOPs: 6 N T over the dense products, 6 times
    the SwiGLU's 3 d f a (token, held expert) pair over the ``pairs``
    counted in the step (all layers), and causal attention's 6 L S H hd a
    token (QK^T and AV, forward and backward, half the square).  Remat's
    recomputation is not counted: it is not the model's work."""
    d, f, H, hd, L = (model["d_model"], model["d_ff"], model["num_heads"],
                      model["head_dim"], model["num_layers"])
    return (6 * dense_matmul_params(model) * tokens
            + 6 * 3 * d * f * pairs
            + 6 * L * seq_len * H * hd * tokens)


def expert_products_bound_s(model: dict, pairs: float, calls: int,
                            passes: int, pk: dict) -> float:
    """Least time of the grouped expert products of ``calls`` layer calls
    (layers x microbatches) holding ``pairs`` pairs in all, each call run
    forward ``passes`` times (2 under remat: the forward and its
    recomputation) and backward once: the larger of

      * operations: 2 d f a pair and matrix, three matrices, forward
        each pass and twice in the backward (the input's and the
        weights' gradients), against the bf16 peak;
      * bytes, each operand read once and each output written once, in
        bf16: a forward reads each matrix (W = held d f) and its rows and
        writes its output rows, 3 W + 3 (d + f) a pair; a backward reads
        each matrix, the rows and the output's gradient and writes the
        two gradients, 6 W + 6 (d + f) a pair; against the HBM bandwidth.

    From the counts alone, so it is the same work whatever kernel runs
    it."""
    d, f, held = model["d_model"], model["d_ff"], model["num_experts"]
    w = held * d * f
    flops = 2 * 3 * d * f * pairs * (passes + 2)
    elems = calls * (3 * w * passes + 6 * w) \
        + pairs * (d + f) * (3 * passes + 6)
    return max(flops / pk["bf16_flops"], 2 * elems / pk["hbm_bytes_per_s"])
