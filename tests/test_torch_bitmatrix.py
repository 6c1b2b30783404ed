"""The bit-matrix form of the GF(2^8) matmul, which the Hopper kernel runs on
int8 tensor cores, and the kernel wrapper's launch arithmetic.

``gf_bitmatrix(A)`` is the GF(2) matrix T (8M x 8K) of multiplication by A;
``gf_matmul_bitmatrix`` is the plain PyTorch product through it.  Both are
held bitwise to the reference package: ``GF8`` (tables), the pure-jnp
``gf_matmul_ref`` and the Pallas kernel in interpret mode.  The CUDA kernel
itself cannot run here; ``launch_plan`` (bands, splits, K padding, chunks,
variant) is plain Python and is checked at every main-path shape.
"""
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.coding.gf import GF8 as REF_GF8
from repro.kernels.gf_matmul import gf_matmul_pallas
from repro.kernels.ref import gf_matmul_ref as jnp_gf_matmul_ref
from repro_torch.kernels import gf_bitmatrix, gf_matmul_bitmatrix, ref

# the module, not the function of that name that the package exports
km = importlib.import_module("repro_torch.kernels.gf_matmul")

# (M, K, N) of every product the Fig. 7 main path of chip_smoke.py runs
# (n=20, k=5, d=10, 240 blocks of 4 MiB): distribute, decode, regenerate,
# encode and relay, and the coding-vector products at N = 240.
_W = 4 << 20
MAIN_PATH_SHAPES = [
    (960, 240, _W), (240, 240, _W),
    (48, 94, _W), (48, 91, _W), (48, 80, _W),
    (11, 48, _W), (10, 48, _W), (9, 48, _W), (8, 48, _W), (6, 48, _W),
    (4, 48, _W),
    (48, 94, 240), (48, 91, 240), (48, 80, 240), (11, 48, 240),
    (10, 48, 240), (9, 48, 240), (8, 48, 240), (6, 48, 240), (4, 48, 240),
]
H100_SMS = 132
SMEM_LIMIT = 232_448      # bytes of shared memory a block may use on Hopper


def _rand(m, k, n, seed):
    rng = np.random.default_rng([seed, m, k, n])
    return (rng.integers(0, 256, (m, k), dtype=np.uint8),
            rng.integers(0, 256, (k, n), dtype=np.uint8))


def _bits(x):
    """(..., 8) 0/1 array of the bits of a uint8 array."""
    return (x[..., None].astype(np.int64) >> np.arange(8)) & 1


def _port(a, b):
    return gf_matmul_bitmatrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _pallas(a, b, blk=128):
    """The reference's Pallas kernel in interpret mode, zero-padded to block
    multiples (as repro.kernels.ops pads) and sliced back."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = (-(-x // blk) * blk for x in (m, k, n))
    ap = np.zeros((mp, kp), np.uint8)
    ap[:m, :k] = a
    bp = np.zeros((kp, np_), np.uint8)
    bp[:k, :n] = b
    out = gf_matmul_pallas(jnp.asarray(ap), jnp.asarray(bp), bm=blk, bn=blk,
                           bk=blk, interpret=True)
    return np.asarray(out)[:m, :n]


def test_bitmatrix_of_every_element_multiplies_every_byte():
    """All 256 x 256 pairs: T_a . bits(b) mod 2 == bits(a . b)."""
    x = np.arange(256, dtype=np.uint8)
    t = gf_bitmatrix(torch.from_numpy(x[:, None])).numpy()   # (8*256, 8)
    assert t.dtype == np.uint8 and t.shape == (8 * 256, 8)
    assert set(np.unique(t)) <= {0, 1}
    t = t.reshape(256, 8, 8).astype(np.int64)                # [a, i, j]
    got = np.einsum("aij,bj->abi", t, _bits(x)) % 2          # [a, b, i]
    want = _bits(REF_GF8.mul(x[:, None], x[None, :]).astype(np.uint8))
    np.testing.assert_array_equal(got, want)


def test_bitmatrix_entries_are_bits_of_powers_of_x():
    a, _ = _rand(3, 5, 1, 0)
    t = gf_bitmatrix(torch.from_numpy(a)).numpy()
    assert t.shape == (24, 40)
    for m in range(3):
        for k in range(5):
            for j in range(8):
                prod = int(REF_GF8.mul(np.array(a[m, k]), np.array(1 << j)))
                for i in range(8):
                    assert t[8 * m + i, 8 * k + j] == (prod >> i) & 1


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (1, 37, 301), (11, 37, 301), (5, 3, 17), (9, 7, 63),
    (8, 48, 240), (48, 94, 65), (33, 130, 100), (3, 5, 2), (17, 33, 9),
    (64, 1024, 64), (2, 1100, 3),
])
def test_bitmatrix_product_matches_reference_oracles(m, k, n):
    """Ragged shapes: K not a multiple of 4, M = 1, N = 1, N not a
    multiple of 64 or of 8."""
    a, b = _rand(m, k, n, 1)
    got = _port(a, b)
    assert got.dtype == np.uint8 and got.shape == (m, n)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))
    np.testing.assert_array_equal(
        got, np.asarray(jnp_gf_matmul_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, ref.gf_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (11, 37, 301), (5, 3, 17),
                                   (128, 512, 128), (9, 130, 65)])
def test_bitmatrix_product_matches_pallas_kernel_interpreted(m, k, n):
    a, b = _rand(m, k, n, 2)
    np.testing.assert_array_equal(_port(a, b), _pallas(a, b))


def test_bitmatrix_product_zero_rows_and_identity():
    a, b = _rand(20, 30, 41, 3)
    a[[0, 7, 19]] = 0
    b[[3, 11]] = 0
    got = _port(a, b)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))
    np.testing.assert_array_equal(got, _pallas(a, b))
    assert not got[[0, 7, 19]].any()
    np.testing.assert_array_equal(_port(np.eye(30, dtype=np.uint8), b), b)
    np.testing.assert_array_equal(_port(a, np.eye(30, dtype=np.uint8)), a)
    np.testing.assert_array_equal(_port(np.zeros_like(a), b),
                                  np.zeros((20, 41), np.uint8))


@pytest.mark.parametrize("m,k,n", [(0, 4, 3), (4, 0, 3), (4, 3, 0)])
def test_bitmatrix_product_empty_dimensions(m, k, n):
    a, b = _rand(m, k, n, 4)
    got = _port(a, b)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 12])
def test_bitmatrix_product_column_chunks(monkeypatch, chunk):
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", chunk)
    a, b = _rand(5, 70, 333, 5)
    np.testing.assert_array_equal(_port(a, b), REF_GF8.matmul(a, b))


def test_bitmatrix_checks_operands():
    with pytest.raises(ValueError):
        gf_bitmatrix(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf_bitmatrix(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        gf_matmul_bitmatrix(torch.zeros((2, 2), dtype=torch.uint8),
                            torch.zeros((2, 2), dtype=torch.int32))


def _tiles_of(plan, n_tiles):
    """The payload tiles each split walks, as the kernel's loop does."""
    return [list(range(x, n_tiles, plan.splits)) for x in range(plan.splits)]


@pytest.mark.parametrize("m,k,n", MAIN_PATH_SHAPES)
def test_launch_plan_covers_every_main_path_shape(m, k, n):
    plan = km.launch_plan(m, k, n, H100_SMS)
    n_tiles = -(-n // km.TILE_COLS)
    # every A row in exactly one band, no empty band
    assert plan.bands * km.BAND_ROWS >= m > (plan.bands - 1) * km.BAND_ROWS
    # every payload tile walked by exactly one split
    walked = sorted(t for ts in _tiles_of(plan, n_tiles) for t in ts)
    assert walked == list(range(n_tiles))
    assert all(_tiles_of(plan, n_tiles))          # no split without work
    # the waves of blocks take as long as the bands' work spread evenly
    # over the SMs (the least there is), or each split is one tile
    blocks = plan.bands * plan.splits
    waves = -(-blocks // H100_SMS)
    assert waves * H100_SMS == blocks or plan.splits == n_tiles
    # K padded to whole unrolled steps, staged in one resident chunk here
    assert plan.k_pad % km.PAD_ROWS == 0 and 0 <= plan.k_pad - k < km.PAD_ROWS
    assert plan.k_chunk == plan.k_pad and plan.n_chunks == 1
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.vec          # N = 4 MiB and N = 240 are multiples of 8


@pytest.mark.parametrize("m,k,n,want", [
    # (bands, splits, k_pad, k_chunk, vec)
    (960, 240, _W, (120, 11, 240, 240, True)),    # distribute: 10 full waves
    (240, 240, _W, (30, 22, 240, 240, True)),     # decode: 5 full waves
    (48, 94, _W, (6, 22, 96, 96, True)),          # regenerate: 132 SMs
    (8, 48, _W, (1, 132, 48, 48, True)),          # encode: one band
    (11, 48, _W, (2, 66, 48, 48, True)),          # a 9th row adds a band
    (8, 48, 240, (1, 1, 48, 48, True)),           # one tile
    (33, 1024, 100_000, (5, 132, 1024, 384, True)),  # K in chunks
    (5, 3, 17, (1, 1, 16, 16, False)),            # N not a multiple of 8
    (7, 13, 1_000_003, (1, 132, 16, 16, False)),
    (3, 0, 5, (1, 1, 16, 16, False)),             # K = 0 writes zeros
])
def test_launch_plan_values(m, k, n, want):
    plan = km.launch_plan(m, k, n, H100_SMS)
    assert (plan.bands, plan.splits, plan.k_pad, plan.k_chunk, plan.vec) == want
    assert plan.n_chunks == -(-plan.k_pad // plan.k_chunk)
    assert plan.smem_bytes == km.SMEM_PER_ROW * plan.k_chunk + km.RING_BYTES


def test_launch_plan_alignment_and_limits():
    assert not km.launch_plan(8, 48, 4096, H100_SMS, aligned=False).vec
    assert km.launch_plan(8, 48, 4096, H100_SMS, aligned=True).vec
    for bad in [(0, 4, 4), (4, 4, 0), (4, -1, 4)]:
        with pytest.raises(ValueError):
            km.launch_plan(*bad, H100_SMS)
    with pytest.raises(ValueError):
        km.launch_plan(8 * (km.MAX_GRID + 1), 4, 4, H100_SMS)
    # more bands than SMs: 33 splits make 50 full waves
    plan = km.launch_plan(8 * 200, 16, 1 << 20, H100_SMS)
    assert (plan.splits, plan.bands * plan.splits) == (33, 50 * H100_SMS)


def test_launch_plan_agrees_with_the_kernel_source():
    """The constants the wrapper plans with are the kernel's own (the
    library also checks this at load time, on the card)."""
    src = km.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    threads = 128 * const("kWarpgroups")
    assert km.BAND_ROWS == const("kBandRows")
    assert km.TILE_COLS == 64 * const("kSub") * const("kWarpgroups")
    assert km.PAD_ROWS == const("kStepRows") * const("kUnroll")
    assert km.CHUNK_ROWS == const("kChunkRows")
    assert km.SMEM_PER_ROW == 8 * 8 * const("kBandRows")
    assert km.RING_BYTES == const("kAhead") * threads * 8
    assert km.SMEM_PER_ROW * km.CHUNK_ROWS + km.RING_BYTES <= SMEM_LIMIT
