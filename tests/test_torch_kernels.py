"""The port's plain GF(2^8) matmul against the reference's kernel and
oracles, and the CPU dispatch of ``repro_torch.kernels.ops``.

The plain version (``gf_matmul_ref``) is what the CPU runs and what
``chip_smoke.py`` holds the CUDA kernel against on the card, so it must be
bitwise equal to ``repro.kernels.ref.gf_matmul_ref``, ``GF8.matmul`` and the
Pallas kernel itself (run in interpret mode at block-multiple shapes, as
``tests/test_kernels.py`` runs it).  The CUDA kernel cannot run here.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.coding.gf import GF8 as REF_GF8
from repro.kernels.gf_matmul import gf_matmul_pallas
from repro.kernels.ref import gf_matmul_ref as jnp_gf_matmul_ref
from repro_torch.kernels import gf_matmul_cuda, ops, ref


def _rand(m, k, n, seed):
    rng = np.random.default_rng([seed, m, k, n])
    return (rng.integers(0, 256, (m, k), dtype=np.uint8),
            rng.integers(0, 256, (k, n), dtype=np.uint8))


def _port(a, b):
    return ref.gf_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (3, 5, 2), (17, 33, 9), (7, 13, 1001), (130, 700, 257),
    (64, 1024, 64), (48, 90, 240), (2, 1100, 3),
])
def test_plain_matches_reference_oracles(m, k, n):
    a, b = _rand(m, k, n, 0)
    got = _port(a, b)
    assert got.dtype == np.uint8 and got.shape == (m, n)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))
    np.testing.assert_array_equal(
        got, np.asarray(jnp_gf_matmul_ref(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (128, 1024, 256)])
def test_plain_matches_pallas_kernel_interpreted(m, k, n):
    """Block multiples, K over one and two 512-blocks."""
    a, b = _rand(m, k, n, 1)
    want = gf_matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(_port(a, b), np.asarray(want))


def test_zero_rows_columns_and_identity():
    a, b = _rand(20, 30, 40, 2)
    a[[0, 7, 19]] = 0
    b[:, [0, 5, 39]] = 0
    b[[3, 11]] = 0
    got = _port(a, b)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))
    assert not got[[0, 7, 19]].any() and not got[:, [0, 5, 39]].any()
    eye = np.eye(30, dtype=np.uint8)
    np.testing.assert_array_equal(_port(a, eye), a)
    np.testing.assert_array_equal(_port(np.zeros_like(a), b),
                                  np.zeros((20, 40), np.uint8))


@pytest.mark.parametrize("m,k,n", [(0, 4, 3), (4, 0, 3), (4, 3, 0)])
def test_empty_dimensions(m, k, n):
    a, b = _rand(m, k, n, 3)
    got = _port(a, b)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, REF_GF8.matmul(a, b))


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 12])
def test_column_chunks(monkeypatch, chunk):
    """The payload is processed in column chunks; the seams must not show."""
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", chunk)
    a, b = _rand(5, 70, 333, 4)
    np.testing.assert_array_equal(_port(a, b), REF_GF8.matmul(a, b))


def test_linearity():
    a, b = _rand(9, 21, 31, 5)
    c = np.random.default_rng(6).integers(0, 256, b.shape, dtype=np.uint8)
    np.testing.assert_array_equal(_port(a, b ^ c), _port(a, b) ^ _port(a, c))


def test_ops_uses_the_plain_version_on_cpu(monkeypatch):
    """A CPU tensor goes to the plain version; the kernel wrapper is never
    reached, so its launch count stays where it was."""
    before = gf_matmul_cuda.launches

    def _no_kernel(*_):
        raise AssertionError("CPU tensors must not reach the kernel")

    monkeypatch.setattr(ops, "gf_matmul_cuda", _no_kernel)
    a, b = _rand(11, 19, 23, 7)
    got = ops.gf_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), REF_GF8.matmul(a, b))
    np.testing.assert_array_equal(ops.gf_matmul_numpy(a, b, device="cpu"),
                                  REF_GF8.matmul(a, b))
    assert gf_matmul_cuda.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on what it cannot launch on."""
    a, b = _rand(4, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gf_matmul_cuda(torch.from_numpy(a), torch.from_numpy(b))
    assert gf_matmul_cuda.launches == 0


@pytest.mark.parametrize("fn", [ops.gf_matmul, ref.gf_matmul_ref,
                                gf_matmul_cuda])
def test_operand_checks(fn):
    a = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fn(a, torch.zeros((5, 2), dtype=torch.uint8))
    with pytest.raises(TypeError):
        fn(a, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        fn(a[0], torch.zeros((4, 2), dtype=torch.uint8))


def test_kernel_build_is_lazy_and_targets_hopper():
    """Importing the kernel module builds nothing; the build targets
    sm_90a from the source in the package."""
    km = importlib.import_module("repro_torch.kernels.gf_matmul")

    assert km.library.cache_info().currsize == 0
    assert "arch=compute_90a,code=sm_90a" in km.NVCC_FLAGS
    assert km.SOURCE.is_file() and km.SOURCE.suffix == ".cu"
    assert "gf256_matmul_launch" in km.SOURCE.read_text()
