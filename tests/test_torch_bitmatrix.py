"""The bit-matrix form of the GF(2^8) matmul, which the Hopper kernel runs on
int8 tensor cores, and the kernel wrapper's launch arithmetic.

``gf_bitmatrix(A)`` is the GF(2) matrix T (8M x 8K) of multiplication by A;
``gf_matmul_bitmatrix`` is the plain PyTorch product through it.  Both are
held bitwise to the reference package: ``GF8`` (tables), the pure-jnp
``gf_matmul_ref`` and the Pallas kernel in interpret mode.  The CUDA kernel
itself cannot run here; ``launch_plan`` (bands, splits, K padding, chunks,
variant) is plain Python and is checked at every main-path shape and at
the checkpoint's odd widths.
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
# (M, K, N) of the checkpoint's big products in chip_smoke.py's phases 6a
# (yi-6b) and 7b (olmo-1b): a block is ceil(payload / 64) bytes, odd at both.
# Save encodes, restore decodes, provider encodes.
CHECKPOINT_SHAPES = [
    (64, 64, 189_407_361), (128, 64, 189_407_361), (6, 16, 189_407_361),
    (128, 64, 199_966_721), (64, 64, 199_966_721),
]


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
    assert plan.variant == km.ALIGNED   # N = 4 MiB and 240 are multiples of 8


@pytest.mark.parametrize("m,k,n,want", [
    # (bands, splits, k_pad, k_chunk, variant)
    (960, 240, _W, (120, 11, 240, 240, "aligned")),  # distribute: 10 full waves
    (240, 240, _W, (30, 22, 240, 240, "aligned")),   # decode: 5 full waves
    (48, 94, _W, (6, 22, 96, 96, "aligned")),        # regenerate: 132 SMs
    (8, 48, _W, (1, 132, 48, 48, "aligned")),        # encode: one band
    (11, 48, _W, (2, 66, 48, 48, "aligned")),        # a 9th row adds a band
    (8, 48, 240, (1, 1, 48, 48, "aligned")),         # one tile
    (33, 1024, 100_000, (5, 132, 1024, 384, "aligned")),  # K in chunks
    (5, 3, 17, (1, 1, 16, 16, "shifted")),           # N not a multiple of 8
    (7, 13, 1_000_003, (1, 132, 16, 16, "shifted")),
    (3, 0, 5, (1, 1, 16, 16, "shifted")),            # K = 0 writes zeros
])
def test_launch_plan_values(m, k, n, want):
    plan = km.launch_plan(m, k, n, H100_SMS)
    v = km.VARIANTS[plan.variant]
    assert (plan.bands, plan.splits, plan.k_pad, plan.k_chunk, v.name) == want
    assert plan.n_chunks == -(-plan.k_pad // plan.k_chunk)
    assert plan.smem_bytes == (km.SMEM_PER_ROW * plan.k_chunk + v.ring_bytes
                               + v.stage_bytes)


@pytest.mark.parametrize("residue", range(1, 8))
@pytest.mark.parametrize("m,k,n", CHECKPOINT_SHAPES)
def test_launch_plan_takes_the_shifted_variant_at_every_odd_width(m, k, n,
                                                                  residue):
    """Every N % 8 != 0 goes to the shifted variant, on the same grid as
    the aligned one at N rounded down to a multiple of 8, with K held in
    one resident chunk."""
    n8 = n - n % 8
    plan = km.launch_plan(m, k, n8 + residue, H100_SMS)
    aligned = km.launch_plan(m, k, n8, H100_SMS)
    assert (plan.variant, aligned.variant) == (km.SHIFTED, km.ALIGNED)
    assert (plan.bands, plan.splits, plan.k_pad) == \
        (aligned.bands, aligned.splits, aligned.k_pad)
    assert plan.k_chunk == plan.k_pad == max(km.PAD_ROWS, k)
    assert plan.n_chunks == 1 and plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("m,k,n", CHECKPOINT_SHAPES[:2])
def test_launch_plan_takes_the_shifted_variant_off_alignment(m, k, n,
                                                             offset):
    """B or C 1..7 bytes off an 8-byte boundary takes the shifted variant
    even at N % 8 == 0 (the wrapper reads the alignment off the pointers)."""
    n8 = n - n % 8
    base = torch.zeros(64, dtype=torch.uint8)
    off, at0 = base[offset:offset + 8], base[:8]
    assert base.data_ptr() % 8 == 0
    for b, c in [(off, at0), (at0, off)]:
        plan = km.launch_plan(m, k, n8, H100_SMS,
                              aligned=km.operands_aligned(b, c))
        assert plan.variant == (km.ALIGNED if offset == 0 else km.SHIFTED)


def test_variant_budgets():
    """Each variant's shared memory (the band's T at its chunk rows, the
    ring, the output staging) fits a Hopper block; the shifted variant's
    16-byte slots double the ring, so it stages fewer rows of T."""
    al, sh = km.VARIANTS
    assert (al.name, al.ahead, al.slot_bytes, al.chunk_rows, al.stage_bytes) \
        == ("aligned", 16, 8, 384, 0)
    assert (sh.name, sh.ahead, sh.slot_bytes, sh.chunk_rows, sh.stage_bytes) \
        == ("shifted", 16, 16, 304, 4096)
    for v in km.VARIANTS:
        smem = km.SMEM_PER_ROW * v.chunk_rows + v.ring_bytes + v.stage_bytes
        assert smem <= SMEM_LIMIT
        assert v.chunk_rows % km.PAD_ROWS == 0 and v.ahead & (v.ahead - 1) == 0
    assert (al.ring_bytes, sh.ring_bytes) == (32_768, 65_536)
    assert km.SMEM_PER_ROW * al.chunk_rows + al.ring_bytes == 229_376
    assert km.SMEM_PER_ROW * sh.chunk_rows + sh.ring_bytes + 4096 == 225_280
    # K past the shifted variant's chunk rows is staged in chunks of them
    plan = km.launch_plan(9, 1024, 1001, H100_SMS)
    assert (plan.variant, plan.k_chunk, plan.n_chunks) == (km.SHIFTED, 304, 4)
    assert plan.smem_bytes == 225_280


def test_launch_plan_alignment_and_limits():
    assert km.launch_plan(8, 48, 4096, H100_SMS,
                          aligned=False).variant == km.SHIFTED
    assert km.launch_plan(8, 48, 4096, H100_SMS,
                          aligned=True).variant == km.ALIGNED
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

    assert km.THREADS == 128 * const("kWarpgroups")
    assert km.BAND_ROWS == const("kBandRows")
    assert km.TILE_COLS == 64 * const("kSub") * const("kWarpgroups")
    assert km.PAD_ROWS == const("kStepRows") * const("kUnroll")
    assert km.SMEM_PER_ROW == 8 * 8 * const("kBandRows")
    assert const("kSmemLimit") == SMEM_LIMIT
    assert (km.ALIGNED, km.SHIFTED) == (const("kAligned"), const("kShifted"))
    for v, name in zip(km.VARIANTS, ("Aligned", "Shifted")):
        assert v.ahead == const(f"k{name}Ahead")
        assert v.slot_bytes == const(f"k{name}Slot")
        assert v.chunk_rows == const(f"k{name}ChunkRows")
        assert km.SMEM_PER_ROW * v.chunk_rows + v.ring_bytes \
            + v.stage_bytes <= SMEM_LIMIT
    assert km.VARIANTS[km.SHIFTED].stage_bytes == km.BAND_ROWS * km.TILE_COLS
    assert km.VARIANTS[km.ALIGNED].stage_bytes == 0
    # every payload load is a cp.async of whole words (no byte loads)
    assert "load_bytes" not in src and "store_pair" not in src
    assert "__ldg" not in src
