"""The weights of a share of DeepSeek-V2 (arXiv:2405.04434; MLA, a leading
dense layer, DeepSeekMoE with shared experts), drawn from ``--seed``:
every leaf under the program's parameter name, in the dtype the program
stores it in (the router in fp32, the rest in the configuration's
``param_dtype``)."""
from __future__ import annotations

import collections
import math
from typing import List, Tuple

import torch

from perfbench.gen import device_generator
from perfbench.gen_moe import NORM_STD


def mla_leaves(model: dict) -> List[Tuple[str, tuple, float, float, bool]]:
    """(name, shape, mean, std, fp32) of every weight: normals of std
    1/sqrt(fan-in) (the embedding and the head 1/sqrt(d_model)), the norms'
    scales (the latent norm's too) normals of mean 1 and std ``NORM_STD``,
    the router in fp32."""
    d, H, V = model["d_model"], model["num_heads"], model["vocab_size"]
    f, E, R = model["d_ff"], model["num_experts"], model["router_experts"]
    r, rd = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    fs, fd = model["shared_experts"] * f, model["dense_d_ff"]

    def fan(n):
        return (0.0, 1 / math.sqrt(n), False)
    norm = (1.0, NORM_STD, False)
    out = []
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        out += [(p + "norm1.scale", (d,)) + norm,
                (p + "attn.wq", (d, H, nope + rd)) + fan(d),
                (p + "attn.wkv_a", (d, r + rd)) + fan(d),
                (p + "attn.kv_norm", (r,)) + norm,
                (p + "attn.wkv_b", (r, H, nope + dv)) + fan(r),
                (p + "attn.wo", (H, dv, d)) + fan(H * dv),
                (p + "norm2.scale", (d,)) + norm]
        if i < model["first_dense"]:
            out += [(p + "mlp.w_gate", (d, fd)) + fan(d),
                    (p + "mlp.w_up", (d, fd)) + fan(d),
                    (p + "mlp.w_down", (fd, d)) + fan(fd)]
        else:
            out += [(p + "moe.router", (d, R), 0.0, 1 / math.sqrt(d), True),
                    (p + "moe.we_gate", (E, d, f)) + fan(d),
                    (p + "moe.we_up", (E, d, f)) + fan(d),
                    (p + "moe.we_down", (E, f, d)) + fan(f),
                    (p + "moe.shared.w_gate", (d, fs)) + fan(d),
                    (p + "moe.shared.w_up", (d, fs)) + fan(d),
                    (p + "moe.shared.w_down", (fs, d)) + fan(fs)]
    out += [("embed.tok", (V, d)) + fan(d), ("embed.unembed", (V, d)) + fan(d),
            ("final_norm.scale", (d,)) + norm]
    return out


def mla_weights(model: dict, seed: int, device, dtype=torch.bfloat16
                ) -> "collections.OrderedDict[str, torch.Tensor]":
    """Every weight, drawn on ``device`` by one fp32 normal draw, then
    scaled and shifted leaf by leaf and stored in ``dtype`` (fp32 for the
    router)."""
    leaves = mla_leaves(model)
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
