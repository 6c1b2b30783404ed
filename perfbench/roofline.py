"""The table of peaks and the functions that count a kernel's operations
and bytes, and a model step's FLOPs, from shapes alone."""
from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit
# (NVIDIA's data sheet): HBM3 bandwidth, bf16 tensor-core FLOP/s, int8
# tensor-core operations/s.  A card set below 700 W reaches less; the
# benchmark reports the card's limit beside every share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops": 989e12,
                              "int8_ops": 1979e12},
}


def peaks(device_name: str):
    """The card's peaks, or None for a card the table does not hold (the
    shares that need them are then not reported)."""
    return PEAKS.get(device_name)


def gf_product_bound_s(m: int, k: int, n: int, pk: dict) -> float:
    """Least time of one (M, K, N) GF(2^8) product C = A B: each operand
    read once and the output written once over HBM, against 64 bit-plane
    int8 multiply-adds (128 int8 operations) per field product on the
    tensor cores; the larger of the two.  From the shapes alone, so it is
    the same work whatever kernel computes it.  (``bound_terms`` of
    chip_smoke.py at commit 945b8950ea47.)"""
    byte_s = (m * k + k * n + m * n) / pk["hbm_bytes_per_s"]
    op_s = 128 * m * k * n / pk["int8_ops"]
    return max(byte_s, op_s)


def decoder_matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product a token: per layer the four
    attention projections and the SwiGLU's three matrices, and the output
    head (the token embedding is a lookup)."""
    d, H, hd, f, V, L = (model["d_model"], model["num_heads"],
                         model["head_dim"], model["d_ff"],
                         model["vocab_size"], model["num_layers"])
    return L * (4 * d * H * hd + 3 * d * f) + V * d


def train_step_flops(model: dict, tokens: int, seq_len: int) -> float:
    """A train step's model FLOPs: 6 N T over the matmul parameters, plus
    causal attention's 6 L S d a token (QK^T and AV, forward and backward,
    half the square).  Remat's recomputation is not counted: it is not
    the model's work."""
    H, hd, L = model["num_heads"], model["head_dim"], model["num_layers"]
    return tokens * (6 * decoder_matmul_params(model)
                     + 6 * L * seq_len * H * hd)


def gf_share(rec, ctx):
    """Percent of the GF(2^8) products' roofline reached in the window:
    the products' least times over their CUDA-event times, both summed."""
    products = rec.samples.get("gf_products", [])
    if not products or ctx.device.type != "cuda":
        return None
    import torch
    pk = peaks(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    bound = sum(gf_product_bound_s(*shape, pk) for shape, _ in products)
    took = sum(t for _, t in products)
    return 100.0 * bound / took if took > 0 else None
