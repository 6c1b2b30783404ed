"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
(target units); encoder-only, non-causal; conv feature extractor is a STUB
(precomputed frame embeddings) [arXiv:2106.07447; unverified]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
        d_ff=5120, vocab_size=504, num_heads=16, num_kv_heads=16,
        head_dim=80, causal=False, frontend="frame_embed",
        norm="layernorm")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio", num_layers=2, d_model=64,
        d_ff=128, vocab_size=64, num_heads=4, num_kv_heads=4, head_dim=16,
        causal=False, frontend="frame_embed", norm="layernorm", q_chunk=16,
        kv_chunk=16, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
