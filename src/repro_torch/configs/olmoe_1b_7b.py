"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304; 64 experts top-8 [arXiv:2409.02060; hf].

This configuration mirrors the reference package's: its MoE is
``models.moe.MoE``, capacity-routed (pairs past 1.25 T K / E drop) with
renormalised top-k gates, and it has no QK-norm and no router losses.
The published OLMoE (dropless, unrenormalised gates, QK-norm, the
load-balancing and z losses) runs through ``models.MoEShareConfig``; the
benchmark's ``perfbench/configs/olmoe-1b-7b-ec8.json`` trains a device's
share of it."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
        d_ff=1024, vocab_size=50304, num_heads=16, num_kv_heads=16,
        head_dim=128, num_experts=64, experts_per_token=8,
        rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe", num_layers=2, d_model=64,
        d_ff=32, vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=16,
        num_experts=4, experts_per_token=2, rope_theta=10_000.0, q_chunk=16,
        kv_chunk=16, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
