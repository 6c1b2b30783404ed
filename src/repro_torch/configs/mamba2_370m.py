"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, ssm_state=128
vocab=50280; SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
        d_ff=0, vocab_size=50280, ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, ssm_conv=4, ssm_chunk=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", num_layers=2, d_model=64,
        d_ff=0, vocab_size=256, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_conv=4, ssm_chunk=8, loss_chunk=16, param_dtype="float32",
        compute_dtype="float32")
