"""The Hopper GF(2^8) matmul kernel: build, bind and launch.

``csrc/gf_matmul.cu`` replaces the TPU kernel ``_gf_matmul_kernel``
(``repro.kernels.gf_matmul.gf_matmul_pallas``); its header says what bounds
it on the card and how it is laid out.  The launch geometry (bands of A,
splits of the payload, K padding and chunks, variant) is computed here in
Python by ``launch_plan``, so the CPU tests reach it; the library checks at
load time that the source's tile constants agree.  The variant is the
aligned one (64-bit loads and stores) for N % 8 == 0 with 8-byte aligned
operands, else the shifted one (aligned words shifted into place).  At
first use the source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/repro_torch/`` at the root
of the checkout (named by a hash of the source and flags, so an edit
rebuilds), and loaded with ``ctypes``.
Nothing is built or imported for CUDA when this module is imported.

There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Tuple

import torch

from ..obs import spans
from .nvcc import BUILD_DIR, NVCC_FLAGS, build_library, load
from .ref import check_operands

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "gf_matmul.cu"


def build() -> Tuple[pathlib.Path, str]:
    """Compile the kernel's shared library into ``BUILD_DIR`` unless it is
    already built.

    Returns (library path, compiler output); the output holds ptxas's
    register and shared-memory report, and is empty when nothing was built.
    """
    return build_library(SOURCE, "libgf_matmul", NVCC_FLAGS, BUILD_DIR)


# The kernel's tile constants (csrc/gf_matmul.cu); ``library()`` checks
# that the built source agrees.
BAND_ROWS = 8        # rows of A per band: 64 output bits, the wgmma N
TILE_COLS = 512      # payload columns per block and tile (2 warpgroups)
PAD_ROWS = 16        # K is padded to a multiple: 4 unrolled steps of 4 rows
SMEM_PER_ROW = 512   # bytes of T per payload row of a band
THREADS = 256        # two warpgroups
MAX_GRID = 65535


@dataclasses.dataclass(frozen=True)
class Variant:
    """How one variant of the kernel moves payload and output bytes.

    ``aligned`` takes N % 8 == 0 with B and C on 8-byte boundaries: 8-byte
    ring slots, 64-bit stores.  ``shifted`` takes any N and base: 16-byte
    slots holding the two aligned words around a thread's 8 bytes, and the
    output staged in shared memory (``stage_bytes``) and written as aligned
    words between single-byte heads and tails.
    """
    name: str
    ahead: int           # payload steps in flight in the ring
    slot_bytes: int      # ring bytes a thread and step
    chunk_rows: int      # payload rows of the band's T in shared memory at once
    stage_bytes: int     # shared memory for a tile's output rows

    @property
    def ring_bytes(self) -> int:
        return self.ahead * THREADS * self.slot_bytes


ALIGNED, SHIFTED = 0, 1          # the launcher's variant numbers
VARIANTS = (Variant("aligned", ahead=16, slot_bytes=8, chunk_rows=384,
                    stage_bytes=0),
            Variant("shifted", ahead=16, slot_bytes=16, chunk_rows=304,
                    stage_bytes=BAND_ROWS * TILE_COLS))
# what the source's ``gf256_geometry`` must report
GEOMETRY = (BAND_ROWS, TILE_COLS, PAD_ROWS, SMEM_PER_ROW) + tuple(
    x for v in VARIANTS
    for x in (v.ahead, v.slot_bytes, v.chunk_rows, v.stage_bytes))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one launch of the bit-matrix kernel.

    The grid is (``splits``, ``bands``): block (x, y) computes A rows
    [8y, 8y + 8) for payload tiles x, x + splits, ...  K is zero-padded to
    ``k_pad`` and staged ``k_chunk`` payload rows at a time (one chunk, held
    for the whole launch, when ``k_pad`` is at most the variant's chunk
    rows).  ``variant`` is ``ALIGNED`` or ``SHIFTED`` (an index of
    ``VARIANTS``).
    """
    bands: int
    splits: int
    k_pad: int
    k_chunk: int
    variant: int

    @property
    def n_chunks(self) -> int:
        return -(-self.k_pad // self.k_chunk)

    @property
    def smem_bytes(self) -> int:
        v = VARIANTS[self.variant]
        return SMEM_PER_ROW * self.k_chunk + v.ring_bytes + v.stage_bytes


@functools.lru_cache(maxsize=1024)
def launch_plan(M: int, K: int, N: int, num_sms: int,
                aligned: bool = True) -> LaunchPlan:
    """Launch geometry for C (M, N) = A (M, K) . B (K, N) on a card with
    ``num_sms`` SMs; ``aligned`` says B and C start on 8-byte boundaries.
    The aligned variant takes N % 8 == 0 with aligned operands, the shifted
    one everything else.

    One block runs on an SM at a time, and blocks start in waves in grid
    order.  Every block of a band does the same work (its share of the
    payload tiles), so ``splits`` is the one (at most one per tile) that
    minimises the waves per split, ceil(bands * splits / num_sms) / splits:
    the time of the launch in units of one band's work.  The splits of a
    band walk interleaved tiles, so the blocks of one wave read the same
    stretch of payload at the same time.
    """
    if M <= 0 or N <= 0 or K < 0 or num_sms <= 0:
        raise ValueError(f"no launch for (M, K, N) = {(M, K, N)} on "
                         f"{num_sms} SMs")
    bands = -(-M // BAND_ROWS)
    if bands > MAX_GRID:
        raise ValueError(f"M = {M} needs {bands} bands, over {MAX_GRID}")
    n_tiles = -(-N // TILE_COLS)
    splits, waves = 1, -(-bands // num_sms)
    for s in range(2, min(n_tiles, num_sms, MAX_GRID) + 1):
        w = -(-bands * s // num_sms)
        if w * splits < waves * s:        # w / s < waves / splits
            splits, waves = s, w
    k_pad = max(PAD_ROWS, -(-K // PAD_ROWS) * PAD_ROWS)
    variant = ALIGNED if aligned and N % 8 == 0 else SHIFTED
    return LaunchPlan(bands=bands, splits=splits, k_pad=k_pad,
                      k_chunk=min(k_pad, VARIANTS[variant].chunk_rows),
                      variant=variant)


def operands_aligned(b: torch.Tensor, c: torch.Tensor) -> bool:
    """Whether the payload ``b`` and the output ``c`` start on 8-byte
    boundaries, as the aligned variant needs."""
    return b.data_ptr() % 8 == 0 and c.data_ptr() % 8 == 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    lib = load(build()[0], SOURCE, "gf256", GEOMETRY)
    lib.gf256_init.argtypes = []
    lib.gf256_init.restype = ctypes.c_int
    lib.gf256_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.gf256_matmul_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    """SMs of ``device``.  The first call for a device also lets the kernel
    use its shared memory there (``gf256_init``)."""
    lib = library()
    with torch.cuda.device(device):
        lib.check(lib.gf256_init(), f"gf256_init on {device}")
    return torch.cuda.get_device_properties(device).multi_processor_count


def gf_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B over GF(2^8) by the Hopper kernel, on A's CUDA device.

    A (M, K) and B (K, N) must be contiguous uint8 CUDA tensors on one
    device; anything else raises.  The output is allocated here and the
    kernel runs on that device's current stream.  The counter
    ``gf.launches`` (``obs.spans``) counts the launches; each is the span
    ``gf.matmul``, and while the profiler records, CUDA events around the
    launch alone give the product's device time (``spans.product``).
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
    plan = launch_plan(M, K, N, device_sms(a.device),
                       aligned=operands_aligned(b, out))
    variant = VARIANTS[plan.variant].name
    lib = library()
    with spans.span("gf.matmul", dict(M=M, K=K, N=N, variant=variant)), \
            torch.cuda.device(a.device):
        events = None
        if spans.on():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gf256_matmul_launch(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), M, K, N, plan.k_pad,
                                      plan.k_chunk, plan.bands, plan.splits,
                                      plan.variant, stream)
        if events is not None:
            events[1].record()
    lib.check(err, f"gf256_matmul launch at (M, K, N) = {(M, K, N)}")
    spans.count("gf.launches")
    if events is not None:
        spans.product((M, K, N), variant, *events)
    return out
