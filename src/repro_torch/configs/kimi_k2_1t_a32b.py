"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840; 384 experts top-8 (trillion-param MoE)
[arXiv:2501.kimi2; unverified]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
        d_ff=2048, vocab_size=163840, num_heads=64, num_kv_heads=8,
        head_dim=112, num_experts=384, experts_per_token=8,
        rope_theta=5e7, loss_chunk=512)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe", num_layers=2, d_model=64,
        d_ff=32, vocab_size=256, num_heads=8, num_kv_heads=2, head_dim=8,
        num_experts=8, experts_per_token=2, rope_theta=5e7, q_chunk=16,
        kv_chunk=16, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
