"""zamba2-7b [hybrid]: 81 Mamba2 layers d_model=3584 ssm_state=64 + two
weight-shared attention blocks (32H, d_ff=14336) applied every 6 layers;
vocab=32000 [arXiv:2411.15242; unverified]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
        d_ff=14336, vocab_size=32000, num_heads=32, num_kv_heads=32,
        head_dim=112, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
        ssm_conv=4, ssm_chunk=256, shared_attn_every=6, num_shared_blocks=2,
        rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", num_layers=4, d_model=64,
        d_ff=128, vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=16,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=8,
        shared_attn_every=2, num_shared_blocks=2, rope_theta=10_000.0,
        q_chunk=16, kv_chunk=16, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
