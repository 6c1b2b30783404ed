"""The Hopper gathers around a MoE expert share's experts: their build,
binding and launches.

``csrc/moe_gather.cu`` computes the share's token-side gather and sum
(:func:`gather_sum`: the combine's forward, the dispatch's backward) and
the combine's backward (:func:`combine_backward`) over the held pairs
alone; its header says what bounds it on the card and how its arithmetic
follows the plain versions' (``models.moe.gather_sum_plain``,
``models.moe.combine_backward_plain``).  ``models.moe`` routes CUDA
tensors here and every other device to the plain versions; a function
here raises on what it cannot launch on, and nothing falls back.

The plan's tensors are those ``models.moe.share_plan`` returns: ``row``
(T, K) int64, ``valid`` (T, K) bool, ``pair`` (R,) int64.  Outputs are
allocated with ``torch.empty`` and each call is one launch on the current
stream, so a captured CUDA graph replays it.

The source is compiled at the first call into one library for ``sm_90a``
under ``build/repro_torch/`` (``kernels.nvcc``, with its flags as they
are) and loaded with ``ctypes``.  Nothing is built when this module is
imported, and neither the package's ``__init__`` nor ``models`` imports
it: ``models.moe`` imports it at the first call on CUDA tensors.  A failed
build or launch raises.

The counter ``moe.gather.launches`` (``obs.spans``) counts the launches,
one a call.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from ..obs import spans
from .nvcc import BUILD_DIR, NVCC_FLAGS, build_library, load

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "moe_gather.cu"
THREADS = 256
VEC = 8                         # consecutive elements a thread takes
KMAX = 8                        # a token's pairs loaded before they are summed
ZERO_ROWS = 8                   # rows a zero-filling block takes
# what the source's ``moe_gather_geometry`` must report
GEOMETRY = (THREADS, VEC, KMAX, ZERO_ROWS)
_SOURCE_DTYPES = (torch.float32, torch.bfloat16)


def build() -> Tuple[pathlib.Path, str]:
    """Compile the library into ``BUILD_DIR`` unless it is built: (path,
    compiler output)."""
    return build_library(SOURCE, "libmoe_gather", NVCC_FLAGS, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built on first call), with
    ``moe_gather_sum_launch`` and ``moe_combine_backward_launch``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = load(build()[0], SOURCE, "moe_gather", GEOMETRY)
    # src, src_bf16, rows, row, valid, scale, T, K, d, out, out_bf16, stream
    lib.moe_gather_sum_launch.argtypes = [p, i, ll, p, p, p, i, i, i, p, i, p]
    lib.moe_gather_sum_launch.restype = i
    # gy, src, src_bf16, rows, gates, row, valid, pair, T, K, d, gye, gg,
    # stream
    lib.moe_combine_backward_launch.argtypes = [p, p, i, ll, p, p, p, p, i,
                                                i, i, p, p, p]
    lib.moe_combine_backward_launch.restype = i
    return lib


def _check(what: str, src: torch.Tensor, row: torch.Tensor,
           valid: torch.Tensor, **others: Optional[torch.Tensor]
           ) -> torch.device:
    """The one CUDA device of every operand, or a ValueError: ``src`` (R,
    d) fp32 or bf16, ``row`` (T, K) int64, ``valid`` (T, K) bool, each
    other operand of the dtype and shape its name asks (``scale`` and
    ``gates`` (T, K) fp32, ``gy`` (T, d) fp32, ``pair`` (R,) int64), every
    one contiguous and on that device (checked last)."""
    given = dict(src=src, row=row, valid=valid,
                 **{n: t for n, t in others.items() if t is not None})
    if src.dim() != 2 or src.dtype not in _SOURCE_DTYPES or \
            row.dim() != 2 or row.dtype != torch.int64 or \
            valid.shape != row.shape or valid.dtype != torch.bool:
        raise ValueError(f"{what}: src {tuple(src.shape)} {src.dtype}, row "
                         f"{tuple(row.shape)} {row.dtype}, valid "
                         f"{tuple(valid.shape)} {valid.dtype}")
    (R, d), (T, K) = src.shape, row.shape
    want = dict(scale=((T, K), torch.float32), gates=((T, K), torch.float32),
                gy=((T, d), torch.float32), pair=((R,), torch.int64))
    for name, t in given.items():
        if name in want and (tuple(t.shape), t.dtype) != want[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype}, "
                             f"want {want[name]}")
    if not all(t.is_contiguous() for t in given.values()):
        raise ValueError(f"{what}: not contiguous")
    if min(R, T, K, d) < 1 or T >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"{what}: sizes R {R}, T {T}, K {K}, d {d}")
    dev = src.device
    if dev.type != "cuda" or any(t.device != dev for t in given.values()):
        got = sorted({str(t.device) for t in given.values()})
        raise ValueError(f"{what} needs its operands on one CUDA device, "
                         f"got {got}")
    return dev


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def gather_sum(src: torch.Tensor, row: torch.Tensor, valid: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(T, d) in ``out_dtype`` (fp32 or ``src``'s dtype): each token's held
    pairs' rows of ``src`` (R, d), times ``scale`` (T, K) if given, summed
    in fp32 in k order; a row past R is read at R - 1.  One launch."""
    if out_dtype not in (torch.float32, src.dtype):
        raise ValueError(f"the MoE gather: out dtype {out_dtype} from "
                         f"{src.dtype}")
    dev = _check("the MoE gather", src, row, valid, scale=scale)
    (R, d), (T, K) = src.shape, row.shape
    out = torch.empty((T, d), dtype=out_dtype, device=dev)
    lib = library()
    c_ = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.check(lib.moe_gather_sum_launch(
            _ptr(src), c_(src.dtype == torch.bfloat16), ctypes.c_longlong(R),
            _ptr(row), _ptr(valid), _ptr(scale), c_(T), c_(K), c_(d),
            _ptr(out), c_(out_dtype == torch.bfloat16),
            ctypes.c_void_p(stream)), "the MoE gather")
    spans.count("moe.gather.launches")
    return out


def combine_backward(gy: torch.Tensor, src: torch.Tensor,
                     gates: torch.Tensor, row: torch.Tensor,
                     valid: torch.Tensor, pair: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine's gradients from ``gy`` (T, d) fp32: (gye (R, d) in
    ``src``'s dtype, row r the gate of its pair times its token's ``gy``
    and zero where its pair is not held; gg (T, K) fp32, each held pair's
    ``gy`` dot its row of ``src``, zero for the others).  One launch."""
    dev = _check("the MoE combine's backward", src, row, valid, gy=gy,
                 gates=gates, pair=pair)
    (R, d), (T, K) = src.shape, row.shape
    gye = torch.empty((R, d), dtype=src.dtype, device=dev)
    gg = torch.empty((T, K), dtype=torch.float32, device=dev)
    lib = library()
    c_ = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.check(lib.moe_combine_backward_launch(
            _ptr(gy), _ptr(src), c_(src.dtype == torch.bfloat16),
            ctypes.c_longlong(R), _ptr(gates), _ptr(row), _ptr(valid),
            _ptr(pair), c_(T), c_(K), c_(d), _ptr(gye), _ptr(gg),
            ctypes.c_void_p(stream)), "the MoE combine's backward")
    spans.count("moe.gather.launches")
    return gye, gg
