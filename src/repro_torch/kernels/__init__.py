"""The port's CUDA kernels for Hopper, each beside its plain PyTorch version.

``csrc/gf_matmul.cu``, the coding plane's GF(2^8) matmul, replaces the
reference's one Pallas kernel (``repro.kernels.gf_matmul``);
``ops.gf_matmul`` dispatches on the device.  ``csrc/attention.cu`` is the
models' fused self-attention, forward and backward (``attention``; its
plain version is ``models.layers.chunked_attention``).
"""
from .attention import fused_attention, fused_attention_engages
from .gf_matmul import gf_matmul_cuda
from .ops import gf_matmul, gf_matmul_numpy
from .ref import gf_bitmatrix, gf_matmul_bitmatrix, gf_matmul_ref

__all__ = ["fused_attention", "fused_attention_engages", "gf_bitmatrix",
           "gf_matmul", "gf_matmul_bitmatrix", "gf_matmul_cuda",
           "gf_matmul_numpy", "gf_matmul_ref"]
