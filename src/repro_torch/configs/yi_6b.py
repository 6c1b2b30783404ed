"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000;
llama-style GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense", num_layers=32, d_model=4096,
        d_ff=11008, vocab_size=64000, num_heads=32, num_kv_heads=4,
        head_dim=128, rope_theta=5e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense", num_layers=2, d_model=64,
        d_ff=176, vocab_size=256, num_heads=8, num_kv_heads=2, head_dim=8,
        rope_theta=5e6, q_chunk=16, kv_chunk=16, loss_chunk=16,
        param_dtype="float32", compute_dtype="float32")
