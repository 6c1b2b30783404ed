"""The port's GF(2^8)/GF(2^16) field against ``repro.coding.gf``, bit for bit.

Inputs are drawn with numpy from fixed seeds; every method must give the
reference's exact output, including on singular and rank-deficient
matrices, and ``random`` must make the reference's draws one for one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.coding import gf as ref_gf
from repro_torch.coding import gf as port_gf

BITS = [8, 16]


def _fields(bits):
    return ((ref_gf.GF8, port_gf.GF8) if bits == 8
            else (ref_gf.GF16, port_gf.GF16))


def _rand(bits, shape, seed, zeros=0.2):
    rng = np.random.default_rng([seed, bits])
    x = rng.integers(0, 1 << bits, size=shape, dtype=np.int64)
    x[rng.random(shape) < zeros] = 0
    return x


def _low_rank(field, m, n, r, seed):
    rng = np.random.default_rng(seed)
    left = field.random((m, r), rng)
    right = field.random((r, n), rng)
    return field.matmul(left, right)


@pytest.mark.parametrize("bits", BITS)
def test_tables_and_constants(bits):
    ref, port = _fields(bits)
    assert (port.q, port.poly, port.dtype) == (ref.q, ref.poly, ref.dtype)
    for name in ("exp", "log", "mul_exp", "mul_log"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert (port_gf.GF8_POLY, port_gf.GF16_POLY) == (0x11D, 0x1100B)
    assert int(port.exp[1]) == 2       # generator 2


@pytest.mark.parametrize("bits", BITS)
def test_elementwise_ops(bits):
    ref, port = _fields(bits)
    a = _rand(bits, (64, 33), 1)
    b = _rand(bits, (64, 33), 2)
    nz = np.where(b == 0, 1, b)
    for got, want in (
        (port.mul(a, b), ref.mul(a, b)),
        (port.inv(nz), ref.inv(nz)),
        (port.div(a, nz), ref.div(a, nz)),
        (port.pow(a, 0), ref.pow(a, 0)),
        (port.pow(a, 5), ref.pow(a, 5)),
        (port.pow(a, (1 << bits) + 3), ref.pow(a, (1 << bits) + 3)),
    ):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ZeroDivisionError):
        port.inv(b)
    with pytest.raises(ZeroDivisionError):
        ref.inv(b)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (5, 7, 3), (17, 40, 9),
                                   (4, 0, 6)])
def test_matmul(bits, m, k, n):
    ref, port = _fields(bits)
    a = _rand(bits, (m, k), 3)
    b = _rand(bits, (k, n), 4)
    np.testing.assert_array_equal(port.matmul(a, b), ref.matmul(a, b))
    np.testing.assert_array_equal(port.matmul(a, b, block_k=3),
                                  ref.matmul(a, b))


@pytest.mark.parametrize("bits", BITS)
def test_rank_full_deficient_and_zero(bits):
    ref, port = _fields(bits)
    cases = [
        _rand(bits, (12, 12), 5, zeros=0.0),
        _rand(bits, (9, 14), 6),
        _low_rank(ref, 10, 10, 4, 7),
        _low_rank(ref, 6, 12, 3, 8),
        np.zeros((5, 5), dtype=np.int64),
    ]
    dup = _rand(bits, (6, 6), 9)
    dup[3] = dup[1]
    cases.append(dup)
    for A in cases:
        assert port.rank(A) == ref.rank(A)
    assert port.rank(_low_rank(ref, 10, 10, 4, 7)) <= 4


@pytest.mark.parametrize("bits", BITS)
def test_solve_and_inverse(bits):
    ref, port = _fields(bits)
    rng = np.random.default_rng(10 + bits)
    A = ref.random((11, 11), rng)
    while ref.rank(A) < 11:
        A = ref.random((11, 11), rng)
    Y = ref.random((11, 5), rng)
    np.testing.assert_array_equal(port.solve(A, Y), ref.solve(A, Y))
    inv = port.inv_matrix(A)
    np.testing.assert_array_equal(inv, ref.inv_matrix(A))
    np.testing.assert_array_equal(port.matmul(inv, A),
                                  np.eye(11, dtype=port.dtype))


@pytest.mark.parametrize("bits", BITS)
def test_solve_singular_raises_like_reference(bits):
    ref, port = _fields(bits)
    A = _low_rank(ref, 8, 8, 5, 11)
    Y = _rand(bits, (8, 2), 12)
    with pytest.raises(np.linalg.LinAlgError):
        ref.solve(A, Y)
    with pytest.raises(np.linalg.LinAlgError):
        port.solve(A, Y)
    with pytest.raises(np.linalg.LinAlgError):
        port.inv_matrix(A)


@pytest.mark.parametrize("bits", BITS)
def test_cauchy(bits):
    ref, port = _fields(bits)
    np.testing.assert_array_equal(port.cauchy_matrix(6, 9),
                                  ref.cauchy_matrix(6, 9))
    if bits == 8:
        for f in (ref, port):
            with pytest.raises(ValueError):
                f.cauchy_matrix(200, 100)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 2), 11])
def test_random_draw_for_draw(bits, shape):
    ref, port = _fields(bits)
    r1 = np.random.default_rng(123)
    r2 = np.random.default_rng(123)
    for _ in range(3):
        want = ref.random(shape, r1)
        got = port.random(shape, r2)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("slab", [1, 7, 64])
def test_random_slabs_keep_the_stream(monkeypatch, slab):
    """Large draws go a slab of rows at a time; the values and the
    generator's state afterwards must equal one reference call."""
    monkeypatch.setattr(port_gf, "_RANDOM_SLAB", slab)
    r1 = np.random.default_rng(77)
    r2 = np.random.default_rng(77)
    for shape in ((13, 5), (9, 3, 3), (1, 1)):
        np.testing.assert_array_equal(port_gf.GF8.random(shape, r2),
                                      ref_gf.GF8.random(shape, r1))
    assert r1.bit_generator.state == r2.bit_generator.state


def test_bad_width():
    with pytest.raises(ValueError):
        port_gf.GF(7)
