"""Architecture zoo: the reference's model families as PyTorch modules
(the counterpart of ``repro.models``)."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .convert import from_reference_params, to_reference_params
from .transformer import (Transformer, decode_step, embed_inputs,
                          forward_hidden, init_cache, init_params, loss_fn,
                          prefill)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "Transformer",
           "decode_step", "embed_inputs", "forward_hidden",
           "from_reference_params", "init_cache", "init_params", "loss_fn",
           "prefill", "to_reference_params"]
