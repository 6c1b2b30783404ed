"""The Hopper fused self-attention kernel: the rule that engages it, and
its build, binding, launch and gradient.

``csrc/attention.cu`` computes ``models.layers.chunked_attention``'s
online softmax for a sequence over itself, forward and backward, with no
score tile in device memory; its header says what bounds it on the card
and how its arithmetic follows the plain version's, operand for operand.
``fused_attention_engages`` is the rule, a pure function of what the
caller can observe (``launch_plan`` is the GF kernel's counterpart):
``models.layers.attention`` takes the kernel where it holds and
``chunked_attention`` (the plain version) everywhere else.

The source is compiled at first use into one library for each head
dimension and causal flag (``-DATTN_HEAD_DIM``, ``-DATTN_CAUSAL``), for
``sm_90a`` under ``build/repro_torch/`` (``kernels.nvcc``), and loaded with
``ctypes``; nothing is built when this module is imported.  There is no
fallback: a failed build or launch raises.

The counters ``attn.launches.forward`` and ``attn.launches.backward``
(``obs.spans``) count the wrapper's launches, one a call of each.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Sequence, Tuple

import torch

from ..obs import spans
from .nvcc import BUILD_DIR, NVCC_FLAGS, build_library

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "attention.cu"
TILE = 64                       # rows of a query or key tile
THREADS = 128
HEAD_DIMS = (64, 128)
MAX_SEQ = 1 << 20               # the tile bounds fit in shared memory


def fused_attention_engages(device: torch.device,
                            dtypes: Sequence[torch.dtype], head_dim: int,
                            seq: int, *, cached: bool,
                            self_attention: bool) -> bool:
    """Whether attention over q, k and v on ``device`` (``dtypes`` their
    dtypes, ``head_dim`` and ``seq`` q's last two sizes but the heads') runs
    on the fused kernel: bf16 CUDA tensors, no KV cache (training and
    prefill), q and k at the same positions (``self_attention``), a head
    dimension the kernel is built for.  The kernel masks a ragged sequence
    itself.  Everything else keeps ``chunked_attention``: the CPU and fp32
    paths, decode over a cache, other head dimensions."""
    return (device.type == "cuda"
            and all(d == torch.bfloat16 for d in dtypes)
            and not cached and self_attention
            and head_dim in HEAD_DIMS and 0 < seq <= MAX_SEQ)


def build(head_dim: int, causal: bool) -> Tuple[pathlib.Path, str]:
    """Compile the library of one head dimension and causal flag into
    ``BUILD_DIR`` unless it is built: (path, compiler output)."""
    return build_library(
        SOURCE, f"libattention_d{head_dim}_{'causal' if causal else 'full'}",
        (*NVCC_FLAGS, f"-DATTN_HEAD_DIM={head_dim}",
         f"-DATTN_CAUSAL={int(causal)}"), BUILD_DIR)


@functools.lru_cache(maxsize=None)
def library(head_dim: int, causal: bool) -> ctypes.CDLL:
    """The loaded library of one variant (built on first call), with
    ``attn_forward`` and ``attn_backward``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(build(head_dim, causal)[0]))
    lib.attn_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.attn_geometry.restype = None
    lib.attn_error_string.argtypes = [i]
    lib.attn_error_string.restype = ctypes.c_char_p
    lib.attn_forward.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.attn_forward.restype = i
    lib.attn_backward.argtypes = [p] * 13 + [i] * 4 + [p]
    lib.attn_backward.restype = i
    geometry = (ctypes.c_int * 4)()
    lib.attn_geometry(geometry)
    if tuple(geometry) != (TILE, head_dim, int(causal), THREADS):
        raise RuntimeError(f"{SOURCE.name} has geometry {tuple(geometry)}, "
                           f"the wrapper {(TILE, head_dim, int(causal), THREADS)}")
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.attn_error_string(err).decode()} ({err})")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (the kernel's cp.async
    loads), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, positions, causal):
        B, S, H, D = q.shape
        KV = k.shape[2]
        lib = library(D, causal)
        grad = any(ctx.needs_input_grad[:3])
        out = torch.empty_like(q)
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
            if grad else None
        stats = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)
        bounds = torch.empty((-(-S // TILE), 2), dtype=torch.int32,
                             device=q.device)
        with torch.cuda.device(q.device):
            err = lib.attn_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
                bounds.data_ptr(), out.data_ptr(), _ptr(o32), stats.data_ptr(),
                B, S, H, KV, torch.cuda.current_stream().cuda_stream)
        _check(lib, err, f"attention forward at {tuple(q.shape)}")
        spans.count("attn.launches.forward")
        if grad:
            ctx.save_for_backward(q, k, v, positions, bounds, o32, stats)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, positions, bounds, o32, stats = ctx.saved_tensors
        B, S, H, D = q.shape
        KV = k.shape[2]
        lib = library(D, ctx.causal)
        g = _operand(g)
        dout32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dl = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, positions, bounds, o32, stats, g, dout32, dl, dq,
                dk, dv)
        with torch.cuda.device(q.device):
            err = lib.attn_backward(
                *(t.data_ptr() for t in args), B, S, H, KV,
                torch.cuda.current_stream().cuda_stream)
        _check(lib, err, f"attention backward at {tuple(q.shape)}")
        spans.count("attn.launches.backward")
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Self-attention of q (B, S, H, D) over k, v (B, S, KV, D) at
    ``positions`` (S values), by the Hopper kernel: ``chunked_attention(q,
    k, v, causal=causal, q_positions=positions, kv_positions=positions,
    ...)``
    without its score tiles, with its gradient (a ``torch.autograd.
    Function`` whose backward is the kernel's).  The operands must be bf16
    on one CUDA device with H a multiple of KV and D in ``HEAD_DIMS``;
    anything else raises."""
    B, S, H, D = q.shape
    if q.device.type != "cuda" or any(
            t.device != q.device or t.dtype != torch.bfloat16
            for t in (q, k, v)):
        raise ValueError("fused_attention needs bf16 operands on one CUDA "
                         f"device, got {[(t.dtype, t.device) for t in (q, k, v)]}")
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D \
            or H % k.shape[2] or D not in HEAD_DIMS \
            or positions.numel() != S or not 0 < S <= MAX_SEQ \
            or max(B, H) > 65535:
        raise ValueError(f"no fused attention for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, positions "
                         f"{tuple(positions.shape)}")
    pos = positions.reshape(S).to(device=q.device,
                                  dtype=torch.int32).contiguous()
    return _FusedAttention.apply(_operand(q), _operand(k), _operand(v), pos,
                                 bool(causal))
