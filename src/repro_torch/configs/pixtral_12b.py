"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend is a STUB (precomputed patch embeddings
for the first 1024 positions) [hf:mistralai/Pixtral-12B-2409; unverified]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", num_layers=40, d_model=5120,
        d_ff=14336, vocab_size=131072, num_heads=32, num_kv_heads=8,
        head_dim=160, rope_theta=1e9, frontend="patch_embed",
        num_frontend_tokens=1024, loss_chunk=512)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm", num_layers=2, d_model=64,
        d_ff=128, vocab_size=256, num_heads=8, num_kv_heads=2, head_dim=8,
        rope_theta=1e9, frontend="patch_embed", num_frontend_tokens=8,
        q_chunk=16, kv_chunk=16, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
