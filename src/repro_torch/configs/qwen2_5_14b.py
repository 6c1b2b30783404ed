"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
        d_ff=13824, vocab_size=152064, num_heads=40, num_kv_heads=8,
        head_dim=128, qkv_bias=True, rope_theta=1e6, loss_chunk=512)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", family="dense", num_layers=2, d_model=64,
        d_ff=160, vocab_size=256, num_heads=8, num_kv_heads=2, head_dim=8,
        qkv_bias=True, rope_theta=1e6, q_chunk=16, kv_chunk=16,
        loss_chunk=16, param_dtype="float32", compute_dtype="float32")
