"""The Hopper fused self-attention kernel: the rule that engages it, and
its build, binding, launch and gradient.

``csrc/attention.cu`` computes ``models.layers.chunked_attention``'s
online softmax for a sequence over itself, forward and backward, with no
score tile in device memory; its header says what bounds it on the card
and how its arithmetic follows the plain version's, operand for operand.
The forward runs on ``mma.sync``; the backward on Hopper's warpgroup
products (``wgmma``) fed by TMA, each TF32 operand (dO' and dS) split
exactly into two bf16 halves, so its products and their exactness are the
TF32 ones.  The backward's scratch for dO' (the size of the output in
fp32) holds those two halves.
``fused_attention_engages`` is the rule, a pure function of what the
caller can observe (``launch_plan`` is the GF kernel's counterpart):
``models.layers.attention`` takes the kernel where it holds and
``chunked_attention`` (the plain version) everywhere else.

The source is compiled at first use into one library for each variant
and causal flag (``-DATTN_HEAD_DIM``, ``-DATTN_V_DIM`` where v is narrower
than q and k, ``-DATTN_CAUSAL``), for ``sm_90a`` under
``build/repro_torch/`` (``kernels.nvcc``), and loaded with ``ctypes``;
nothing is built when this module is imported, and a variant's library
only at that variant's first call.  The variants (``VARIANTS``): q, k and
v of one width, 64 or 128 (``HEAD_DIMS``); or q and k at 192 with v at
128, multi-head latent attention's (``models.mla.MLAttention``).  The
softmax scale is an argument (1/sqrt of q's width unless given).  There
is no fallback: a failed build or launch raises.

The counters ``attn.launches.forward`` and ``attn.launches.backward``
(``obs.spans``) count the wrapper's launches, one a call of each, and
``attn.launches.forward.d<D>v<DV>`` and ``.backward.d<D>v<DV>`` those of
each variant.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import Optional, Sequence, Tuple

import torch

from ..obs import spans
from .nvcc import BUILD_DIR, NVCC_FLAGS, build_library, load

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "attention.cu"
TILE = 64                       # rows of a query or key tile
THREADS = 128
HEAD_DIMS = (64, 128)           # q, k and v of one width
VARIANTS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)  # (q-k, v)
MAX_SEQ = 1 << 20               # the tile bounds fit in shared memory


def fused_attention_engages(device: torch.device,
                            dtypes: Sequence[torch.dtype], head_dim: int,
                            seq: int, *, cached: bool,
                            self_attention: bool,
                            v_dim: Optional[int] = None) -> bool:
    """Whether attention over q, k and v on ``device`` (``dtypes`` their
    dtypes, ``head_dim`` and ``seq`` q's last two sizes but the heads',
    ``v_dim`` v's last, ``head_dim`` unless given) runs on the fused
    kernel: bf16 CUDA tensors, no KV cache (training and prefill), q and k
    at the same positions (``self_attention``), widths the kernel is built
    for (``VARIANTS``).  The kernel masks a ragged sequence itself.
    Everything else keeps ``chunked_attention``: the CPU and fp32 paths,
    decode over a cache, other widths."""
    v_dim = head_dim if v_dim is None else v_dim
    return (device.type == "cuda"
            and all(d == torch.bfloat16 for d in dtypes)
            and not cached and self_attention
            and (head_dim, v_dim) in VARIANTS and 0 < seq <= MAX_SEQ)


def _variant(head_dim: int, v_dim: Optional[int]) -> str:
    """``d<D>`` for one width, ``d<D>v<DV>`` where v's differs."""
    return f"d{head_dim}" if v_dim in (None, head_dim) \
        else f"d{head_dim}v{v_dim}"


def build(head_dim: int, causal: bool, v_dim: Optional[int] = None,
          build_dir: pathlib.Path = BUILD_DIR) -> Tuple[pathlib.Path, str]:
    """Compile the library of one variant (v as wide as q and k unless
    ``v_dim`` says otherwise) and causal flag into ``build_dir`` unless it
    is built there: (path, compiler output, with ptxas's report)."""
    narrow = () if v_dim in (None, head_dim) else (f"-DATTN_V_DIM={v_dim}",)
    return build_library(
        SOURCE, f"libattention_{_variant(head_dim, v_dim)}_"
        f"{'causal' if causal else 'full'}",
        (*NVCC_FLAGS, f"-DATTN_HEAD_DIM={head_dim}", *narrow,
         f"-DATTN_CAUSAL={int(causal)}"), build_dir)


@functools.lru_cache(maxsize=None)
def library(head_dim: int, causal: bool, v_dim: Optional[int] = None
            ) -> ctypes.CDLL:
    """The loaded library of one variant (built on first call), with
    ``attn_forward`` and ``attn_backward``; its geometry carries v's width
    where it differs from the head dimension."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    narrow = () if v_dim in (None, head_dim) else (v_dim,)
    lib = load(build(head_dim, causal, v_dim)[0], SOURCE, "attn",
               (TILE, head_dim, int(causal), THREADS, *narrow))
    lib.attn_forward.argtypes = [p] * 8 + [i] * 4 + [f, p]
    lib.attn_forward.restype = i
    lib.attn_backward.argtypes = [p] * 13 + [i] * 4 + [f, p]
    lib.attn_backward.restype = i
    return lib


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (the forward's cp.async loads
    and the backward's TMA copies), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, positions, causal, scale):
        B, S, H, D = q.shape
        KV, DV = k.shape[2], v.shape[3]
        narrow = None if DV == D else DV
        lib = library(D, causal, narrow)
        grad = any(ctx.needs_input_grad[:3])
        out = q.new_empty((B, S, H, DV))
        o32 = torch.empty(out.shape, dtype=torch.float32, device=q.device) \
            if grad else None
        stats = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)
        bounds = torch.empty((-(-S // TILE), 2), dtype=torch.int32,
                             device=q.device)
        with torch.cuda.device(q.device):
            err = lib.attn_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
                bounds.data_ptr(), out.data_ptr(), _ptr(o32), stats.data_ptr(),
                B, S, H, KV, scale, torch.cuda.current_stream().cuda_stream)
        lib.check(err, f"attention forward at {tuple(q.shape)}")
        spans.count("attn.launches.forward")
        spans.count(f"attn.launches.forward.d{D}v{DV}")
        if grad:
            ctx.save_for_backward(q, k, v, positions, bounds, o32, stats)
        ctx.causal, ctx.scale, ctx.narrow = causal, scale, narrow
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, positions, bounds, o32, stats = ctx.saved_tensors
        B, S, H, D = q.shape
        KV, DV = k.shape[2], v.shape[3]
        lib = library(D, ctx.causal, ctx.narrow)
        g = _operand(g)
        dout32 = torch.empty(o32.shape, dtype=torch.float32, device=q.device)
        dl = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, positions, bounds, o32, stats, g, dout32, dl, dq,
                dk, dv)
        with torch.cuda.device(q.device):
            err = lib.attn_backward(
                *(t.data_ptr() for t in args), B, S, H, KV, ctx.scale,
                torch.cuda.current_stream().cuda_stream)
        lib.check(err, f"attention backward at {tuple(q.shape)}")
        spans.count("attn.launches.backward")
        spans.count(f"attn.launches.backward.d{D}v{DV}")
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention of q (B, S, H, D) over k (B, S, KV, D) and v (B, S,
    KV, DV) at ``positions`` (S values), the scores scaled by ``scale``
    (1/sqrt(D) unless given), by the Hopper kernel:
    ``chunked_attention(q, k, v, causal=causal, q_positions=positions,
    kv_positions=positions, scale=scale, ...)`` without its score tiles,
    with its gradient (a ``torch.autograd.Function`` whose backward is the
    kernel's); the output is (B, S, H, DV).  The operands must be bf16 on
    one CUDA device with H a multiple of KV and (D, DV) in ``VARIANTS``;
    anything else raises."""
    B, S, H, D = q.shape
    if q.device.type != "cuda" or any(
            t.device != q.device or t.dtype != torch.bfloat16
            for t in (q, k, v)):
        raise ValueError("fused_attention needs bf16 operands on one CUDA "
                         f"device, got {[(t.dtype, t.device) for t in (q, k, v)]}")
    if k.shape[:3] != v.shape[:3] or k.shape[:2] != (B, S) \
            or k.shape[3] != D or H % k.shape[2] \
            or (D, v.shape[3]) not in VARIANTS \
            or positions.numel() != S or not 0 < S <= MAX_SEQ \
            or max(B, H) > 65535:
        raise ValueError(f"no fused attention for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, positions "
                         f"{tuple(positions.shape)}")
    pos = positions.reshape(S).to(device=q.device,
                                  dtype=torch.int32).contiguous()
    return _FusedAttention.apply(
        _operand(q), _operand(k), _operand(v), pos, bool(causal),
        1.0 / math.sqrt(D) if scale is None else float(scale))
