"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936; QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense", num_layers=24, d_model=1024,
        d_ff=2816, vocab_size=151936, num_heads=16, num_kv_heads=16,
        head_dim=64, qkv_bias=True, rope_theta=1e6, loss_chunk=512)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-smoke", family="dense", num_layers=2, d_model=48,
        d_ff=96, vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=12,
        qkv_bias=True, rope_theta=1e6, q_chunk=16, kv_chunk=16,
        loss_chunk=16, param_dtype="float32", compute_dtype="float32")
