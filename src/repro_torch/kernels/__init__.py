"""The coding plane's GF(2^8) matmul: a CUDA kernel for Hopper and its plain
PyTorch version.

``csrc/gf_matmul.cu`` replaces the reference's one Pallas kernel
(``repro.kernels.gf_matmul``); ``ops.gf_matmul`` dispatches on the device.
"""
from .gf_matmul import gf_matmul_cuda
from .ops import gf_matmul, gf_matmul_numpy
from .ref import gf_bitmatrix, gf_matmul_bitmatrix, gf_matmul_ref

__all__ = ["gf_bitmatrix", "gf_matmul", "gf_matmul_bitmatrix", "gf_matmul_cuda",
           "gf_matmul_numpy", "gf_matmul_ref"]
