"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304;
non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense", num_layers=16, d_model=2048,
        d_ff=8192, vocab_size=50304, num_heads=16, num_kv_heads=16,
        head_dim=128, norm="nonparam_ln", rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense", num_layers=2, d_model=64,
        d_ff=128, vocab_size=256, num_heads=4, num_kv_heads=4, head_dim=16,
        norm="nonparam_ln", rope_theta=10_000.0, q_chunk=16, kv_chunk=16,
        loss_chunk=16, param_dtype="float32", compute_dtype="float32")
