"""The Hopper GF(2^8) matmul kernel: build, bind and launch.

``csrc/gf_matmul.cu`` replaces the TPU kernel ``_gf_matmul_kernel``
(``repro.kernels.gf_matmul.gf_matmul_pallas``); its header says what bounds
it on the card and how it is laid out.  At first use the source is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/repro_torch/`` at the root of the checkout (named by a hash of
the source and flags, so an edit rebuilds), and loaded with ``ctypes``.
Nothing is built or imported for CUDA when this module is imported.

There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Tuple

import numpy as np
import torch

from .ref import check_operands

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "gf_matmul.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"nvcc not found under {home} or on PATH")


def build() -> Tuple[pathlib.Path, str]:
    """Compile the kernel's shared library into ``BUILD_DIR`` unless it is
    already built.

    Returns (library path, compiler output); the output holds ptxas's
    register and shared-memory report, and is empty when nothing was built.
    """
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libgf_matmul_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib, proc.stdout + proc.stderr


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.gf256_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.gf256_init.argtypes = []
    lib.gf256_init.restype = ctypes.c_int
    lib.gf256_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.gf256_matmul_launch.restype = ctypes.c_int
    lib.gf256_error_string.argtypes = [ctypes.c_int]
    lib.gf256_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def mul_table(device: torch.device) -> torch.Tensor:
    """The 256 x 256 GF(2^8) product table, row-major (entry a*256+b = a.b),
    on ``device``; the kernel stages it in shared memory.  The first call
    for a device also lets the kernel use that much shared memory there."""
    from ..coding.gf import GF8   # here: repro_torch.coding imports this module

    lib = library()
    with torch.cuda.device(device):
        _check(lib, lib.gf256_init(), f"gf256_init on {device}")
    x = np.arange(256)
    return torch.from_numpy(GF8.mul(x[:, None], x[None, :])).to(device)


def gf_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over GF(2^8) by the Hopper kernel, on A's CUDA device.

    A (M, K) and B (K, N) must be contiguous uint8 CUDA tensors on one
    device; anything else raises.  The output is allocated here and the
    kernel runs on that device's current stream.  ``gf_matmul_cuda.launches``
    counts the launches.
    """
    check_operands(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gf_matmul_cuda needs CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gf_matmul_cuda needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.uint8, device=a.device)
    if M == 0 or N == 0:
        return out
    table = mul_table(a.device)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gf256_matmul_launch(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), table.data_ptr(),
                                      M, K, N, stream)
    _check(lib, err, f"gf256_matmul launch at (M, K, N) = {(M, K, N)}")
    gf_matmul_cuda.launches += 1
    return out


gf_matmul_cuda.launches = 0
