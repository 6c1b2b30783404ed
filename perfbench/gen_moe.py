"""The weights of an expert share of OLMoE (arXiv:2409.02060), drawn from
``--seed``: every leaf under the program's parameter name, in the dtype
the program stores it in (the router in fp32, the rest in the
configuration's ``param_dtype``)."""
from __future__ import annotations

import collections
import math
from typing import List, Tuple

import torch

from perfbench.gen import device_generator

NORM_STD = 0.1


def moe_leaves(model: dict) -> List[Tuple[str, tuple, float, float, bool]]:
    """(name, shape, mean, std, fp32) of every weight: normals of std
    1/sqrt(fan-in) (the embedding and the head 1/sqrt(d_model)), the norms'
    scales normals of mean 1 and std ``NORM_STD`` (not ones: a program that
    left a scale out would then still agree), the router in fp32."""
    d, H, KV, hd, f, V = (model["d_model"], model["num_heads"],
                          model["num_kv_heads"], model["head_dim"],
                          model["d_ff"], model["vocab_size"])
    E, R = model["num_experts"], model["router_experts"]
    fan = (0.0, 1 / math.sqrt(d), False)
    norm = (1.0, NORM_STD, False)
    out = []
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        out += [(p + "norm1.scale", (d,)) + norm,
                (p + "attn.wq", (d, H, hd)) + fan,
                (p + "attn.wk", (d, KV, hd)) + fan,
                (p + "attn.wv", (d, KV, hd)) + fan,
                (p + "attn.wo", (H, hd, d), 0.0, 1 / math.sqrt(H * hd), False),
                (p + "attn.q_norm", (H * hd,)) + norm,
                (p + "attn.k_norm", (KV * hd,)) + norm,
                (p + "norm2.scale", (d,)) + norm,
                (p + "moe.router", (d, R), 0.0, 1 / math.sqrt(d), True),
                (p + "moe.we_gate", (E, d, f)) + fan,
                (p + "moe.we_up", (E, d, f)) + fan,
                (p + "moe.we_down", (E, f, d), 0.0, 1 / math.sqrt(f), False)]
    out += [("embed.tok", (V, d)) + fan, ("embed.unembed", (V, d)) + fan,
            ("final_norm.scale", (d,)) + norm]
    return out


def moe_weights(model: dict, seed: int, device, dtype=torch.bfloat16
                ) -> "collections.OrderedDict[str, torch.Tensor]":
    """Every weight, drawn on ``device`` by one fp32 normal draw, then
    scaled and shifted leaf by leaf and stored in ``dtype`` (fp32 for the
    router)."""
    leaves = moe_leaves(model)
    total = sum(math.prod(s) for _, s, _, _, _ in leaves)
    buf = torch.randn(total, dtype=torch.float32, device=device,
                      generator=device_generator(seed, 1, device))
    out, off = collections.OrderedDict(), 0
    for name, shape, mu, std, fp32 in leaves:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape).mul_(std).add_(mu)
        out[name] = leaf.clone() if fp32 else leaf.to(dtype)
        off += n
    del buf
    return out
