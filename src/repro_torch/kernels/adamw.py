"""The Hopper fused AdamW: its chunk map, build, binding and launches.

``csrc/adamw.cu`` updates every parameter of a model in two launches, a
sum of squares of the gradients and the update itself; its header says
what bounds it on the card and how its arithmetic follows the plain
version's (``train.optimizer._plain_update``), operation for operation.
``train.optimizer`` routes AdamW over CUDA tensors here and everything
else (the CPU, Adafactor) to the plain version; nothing falls back.

The pointers, sizes and dtypes of up to ``MAX_TENSORS`` tensors and their
chunk map (:func:`chunk_map`, a pure function) are one kernel parameter
passed by value, so a captured CUDA graph replays the launches with no
host copy; ``step`` and ``lr`` are read from device memory.  The partial
sums of squares and ``lr`` live in a :class:`FusedAdamW`'s scratch,
allocated at its first call and reused.

The source is compiled at the first call into one library for ``sm_90a``
under ``build/repro_torch/`` (``kernels.nvcc``, with its flags as they
are) and loaded with ``ctypes``.  Nothing is built when this module is
imported, and the package's ``__init__`` does not import it: the repair and
planning paths never load it.  A failed build or launch raises.

The counter ``optim.launches`` (``obs.spans``) counts the wrapper's
launches: two a call for a model of at most ``MAX_TENSORS`` tensors.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..obs import spans
from .nvcc import BUILD_DIR, NVCC_FLAGS, build_library, load

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "adamw.cu"
THREADS = 256
VEC = 8                         # consecutive elements a thread takes
CHUNK = 1 << 16                 # elements a chunk
MAX_TENSORS = 256               # tensors a launch
BLOCKS_PER_SM = 4
# the source's ``Tensors``: four pointers, a size, a first chunk and a
# dtype byte a tensor, the chunks in all, the count
TENSORS_BYTES = MAX_TENSORS * (4 * 8 + 8 + 4 + 1) + 4 + 4
# what the source's ``adamw_geometry`` must report
GEOMETRY = (THREADS, VEC, CHUNK, MAX_TENSORS, TENSORS_BYTES)
PARAM_LIMIT = 32764             # bytes of kernel parameters on Hopper
# the update's other parameters: eight floats, four pointers and an int
# (padded to 8 bytes)
OTHER_PARAM_BYTES = 8 * 4 + 4 * 8 + 2 * 4
P_BF16, M_BF16, G_BF16 = 1, 2, 4     # the source's ``kind`` bits
_KIND_DTYPES = (torch.float32, torch.bfloat16)


class Group(NamedTuple):
    """One launch of each kind: tensors ``lo`` to ``hi`` (exclusive) of
    the list, and the chunk at which each of them starts, counted from
    the group's first, with the group's chunks in all last."""
    lo: int
    hi: int
    first_chunk: Tuple[int, ...]


def chunk_map(numels: Sequence[int], chunk: int = CHUNK,
              max_tensors: int = MAX_TENSORS) -> List[Group]:
    """The launches for tensors of ``numels`` elements: consecutive groups
    of at most ``max_tensors`` tensors, each tensor cut into chunks of
    ``chunk`` elements (its last one ragged; none for an empty tensor).
    The kernel's chunk c of a group is chunk ``c - first_chunk[i]`` of the
    group's tensor i, the last with ``first_chunk[i] <= c``."""
    groups = []
    for lo in range(0, len(numels), max_tensors):
        hi = min(lo + max_tensors, len(numels))
        starts = [0]
        for n in numels[lo:hi]:
            if n < 0:
                raise ValueError(f"a tensor of {n} elements")
            starts.append(starts[-1] + -(-n // chunk))
        if starts[-1] >= 2 ** 31:
            raise ValueError(f"{starts[-1]} chunks in one launch")
        groups.append(Group(lo, hi, tuple(starts)))
    return groups


def build() -> Tuple[pathlib.Path, str]:
    """Compile the library into ``BUILD_DIR`` unless it is built: (path,
    compiler output)."""
    return build_library(SOURCE, "libadamw", NVCC_FLAGS, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built on first call), with
    ``adamw_sumsq_launch`` and ``adamw_update_launch``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = load(build()[0], SOURCE, "adamw", GEOMETRY)
    # p, g, m, v, numel, first_chunk, kind, count
    tensors = [p] * 7 + [i]
    lib.adamw_sumsq_launch.argtypes = tensors + [f, p, i, p]
    lib.adamw_sumsq_launch.restype = i
    lib.adamw_update_launch.argtypes = tensors + [f] * 8 + [p, i, p, p, p,
                                                            i, p]
    lib.adamw_update_launch.restype = i
    return lib


def kind(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor) -> int:
    """The source's dtype bits of a parameter, its gradient and moments."""
    return ((P_BF16 if p.dtype == torch.bfloat16 else 0)
            | (M_BF16 if m.dtype == torch.bfloat16 else 0)
            | (G_BF16 if g.dtype == torch.bfloat16 else 0))


def check_operands(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                   step: torch.Tensor,
                   sumsq: Optional[torch.Tensor] = None) -> torch.device:
    """The one CUDA device of every operand, or a ValueError: parameters
    bf16 or fp32, gradients bf16 or fp32, each parameter's m and v of one
    dtype, bf16 or fp32, the four of a parameter of its shape, every one
    contiguous; ``step`` one int32 and ``sumsq`` (if given) one fp64."""
    if not params or not len(params) == len(grads) == len(m) == len(v):
        raise ValueError(f"fused AdamW over {len(params)} parameters, "
                         f"{len(grads)} gradients, {len(m)} and {len(v)} "
                         f"moments")
    for i, quad in enumerate(zip(params, grads, m, v)):
        p, _, mi, vi = quad
        if any(t.dtype not in _KIND_DTYPES for t in quad) or \
                mi.dtype != vi.dtype:
            raise ValueError(f"tensor {i}: dtypes "
                             f"{[t.dtype for t in quad]}: want bf16 or fp32,"
                             f" m and v alike")
        if any(t.shape != p.shape for t in quad):
            raise ValueError(f"tensor {i}: shapes "
                             f"{[tuple(t.shape) for t in quad]}")
        if not all(t.is_contiguous() for t in quad):
            raise ValueError(f"tensor {i}: not contiguous")
    dev = params[0].device
    others = [*params, *grads, *m, *v, step] + \
        ([] if sumsq is None else [sumsq])
    if dev.type != "cuda" or any(t.device != dev for t in others):
        got = sorted({str(t.device) for t in others})
        raise ValueError(f"fused AdamW needs its operands on one CUDA "
                         f"device, got {got}")
    if step.dtype != torch.int32 or step.numel() != 1:
        raise ValueError(f"step: {step.numel()} of {step.dtype}; want one "
                         f"int32")
    if sumsq is not None and (sumsq.numel() != 1
                              or sumsq.dtype != torch.float64):
        raise ValueError(f"sumsq: {sumsq.numel()} of {sumsq.dtype}; want "
                         f"one fp64")
    return dev


def _array(ctype, values):
    return (ctype * len(values))(*values)


class FusedAdamW:
    """One optimizer's fused AdamW: :meth:`__call__` launches the kernels
    over a model's tensors.  Its scratch, the partial sums of squares and
    ``lr`` on the device, is allocated at the first call (in a train step,
    the eager warm-up before a capture) and reused by every later call, so
    a step allocates nothing but the norm it returns."""

    def __init__(self):
        self._partials: Optional[torch.Tensor] = None
        self._lr: Optional[torch.Tensor] = None

    def _scratch(self, dev: torch.device, partials: int) -> None:
        if self._lr is None or self._lr.device != dev:
            self._lr = torch.empty(1, dtype=torch.float32, device=dev)
            self._partials = None
        if self._partials is None or self._partials.numel() < partials:
            self._partials = torch.empty(partials, dtype=torch.float64,
                                         device=dev)

    def __call__(self, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                 v: Sequence[torch.Tensor], step: torch.Tensor,
                 lr: Union[float, torch.Tensor], *, b1: float, b2: float,
                 eps: float, weight_decay: float, grad_clip: float,
                 n_micro: int = 1,
                 sumsq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """AdamW on ``params`` in place (and ``m``, ``v``), from ``grads``
        divided by ``n_micro`` and clipped to a global norm of
        ``grad_clip``, at step ``step + 1`` (``step`` is not advanced), at
        learning rate ``lr`` (a float or a device scalar).  The norm is the
        gradients' (sum of squares by the first launch), or, given
        ``sumsq`` (an fp64 device scalar: the gradients' sum of squares,
        already divided), ``sqrt(sumsq)`` with the first launch skipped.
        Returns the norm, an fp32 0-d tensor."""
        dev = check_operands(params, grads, m, v, step, sumsq)
        groups = chunk_map([p.numel() for p in params])
        grid = (torch.cuda.get_device_properties(dev).multi_processor_count
                * BLOCKS_PER_SM)
        lib = library()
        self._scratch(dev, grid * len(groups))
        norm = torch.empty((), dtype=torch.float32, device=dev)
        p_, c_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        hyper = [f_(b1), f_(b2), f_(1.0 - b1), f_(1.0 - b2), f_(eps),
                 f_(weight_decay), f_(grad_clip), f_(float(n_micro))]
        with torch.cuda.device(dev):
            if isinstance(lr, torch.Tensor):
                self._lr.copy_(lr.reshape(1))
            else:
                self._lr.fill_(lr)
            stream = torch.cuda.current_stream(dev).cuda_stream
            args = []
            for grp in groups:
                span = range(grp.lo, grp.hi)
                ptrs = [_array(p_, [ts[i].data_ptr() for i in span])
                        for ts in (params, grads, m, v)]
                args.append(ptrs + [
                    _array(ctypes.c_longlong,
                           [params[i].numel() for i in span]),
                    _array(c_, grp.first_chunk),
                    _array(ctypes.c_ubyte,
                           [kind(params[i], grads[i], m[i]) for i in span]),
                    c_(grp.hi - grp.lo)])
            if sumsq is None:
                base = self._partials.data_ptr()
                for k, a in enumerate(args):
                    lib.check(lib.adamw_sumsq_launch(
                        *a, f_(float(n_micro)), p_(base + 8 * k * grid),
                        c_(grid), p_(stream)), "fused AdamW's sum of squares")
                    spans.count("optim.launches")
                partials, n_partials = base, grid * len(groups)
            else:
                partials, n_partials = sumsq.data_ptr(), 1
            for k, a in enumerate(args):
                lib.check(lib.adamw_update_launch(
                    *a, *hyper, p_(partials), c_(n_partials),
                    p_(norm.data_ptr() if k == 0 else None),
                    p_(step.data_ptr()), p_(self._lr.data_ptr()), c_(grid),
                    p_(stream)), "fused AdamW's update")
                spans.count("optim.launches")
        return norm
