"""The port's RLNC coding plane against ``repro.coding.rlnc``, bit for bit.

Both sides take the same numpy generator state; the port runs on CPU
tensors (the plain GF matmul), the reference on numpy arrays.  Vectors and
payloads of every operation must be equal, and ``reconstruct`` must pick
the reference's rows and return the file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.coding import RLNC as RefRLNC, CodedBlocks as RefBlocks
from repro.coding.gf import GF8 as REF_GF8
from repro_torch.coding import GF8, GF16, RLNC, CodedBlocks, independent_rows

M, N_NODES, ALPHA, BLOCK = 12, 6, 4, 33


def _same(port: CodedBlocks, ref: RefBlocks):
    np.testing.assert_array_equal(port.vectors.numpy(), ref.vectors)
    np.testing.assert_array_equal(port.payload.numpy(), ref.payload)


def _t(blocks: RefBlocks) -> CodedBlocks:
    return CodedBlocks(torch.from_numpy(blocks.vectors),
                       torch.from_numpy(blocks.payload))


def _pair(seed):
    rng = np.random.default_rng(seed)
    file_blocks = REF_GF8.random((M, BLOCK), rng)
    return file_blocks, rng.bit_generator.state


def _rngs(state):
    r1 = np.random.default_rng()
    r2 = np.random.default_rng()
    r1.bit_generator.state = state
    r2.bit_generator.state = state
    return r1, r2


@pytest.fixture
def planes():
    ref = RefRLNC(REF_GF8)
    port = RLNC(GF8, device="cpu")
    file_blocks, state = _pair(2024)
    r1, r2 = _rngs(state)
    ref_nodes = ref.distribute(file_blocks, N_NODES, ALPHA, r1)
    port_nodes = port.distribute(torch.from_numpy(file_blocks), N_NODES,
                                 ALPHA, r2)
    return ref, port, file_blocks, ref_nodes, port_nodes, r1, r2


def test_distribute(planes):
    _, _, _, ref_nodes, port_nodes, r1, r2 = planes
    assert len(port_nodes) == N_NODES
    for p, r in zip(port_nodes, ref_nodes):
        assert p.num == ALPHA
        _same(p, r)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("num_out", [1, 3, ALPHA, 7])
def test_encode(planes, num_out):
    ref, port, _, ref_nodes, port_nodes, r1, r2 = planes
    _same(port.encode(port_nodes[2], num_out, r2),
          ref.encode(ref_nodes[2], num_out, r1))


@pytest.mark.parametrize("num_out", [2, 5, 9])
def test_relay_and_regenerate(planes, num_out):
    ref, port, _, ref_nodes, port_nodes, r1, r2 = planes
    rr = ref.encode(ref_nodes[0], 3, r1)
    pr = port.encode(port_nodes[0], 3, r2)
    ro = ref.encode(ref_nodes[1], 2, r1)
    po = port.encode(port_nodes[1], 2, r2)
    rrel = ref.relay(rr, ro, num_out, r1)
    prel = port.relay(pr, po, num_out, r2)
    _same(prel, rrel)
    _same(port.regenerate(prel.concat(po), ALPHA, r2),
          ref.regenerate(rrel.concat(ro), ALPHA, r1))


def _reference_rows(V, M):
    """The row choice of repro.coding.rlnc.RLNC.reconstruct (one rank call
    per candidate row), restated to expose the indices."""
    idx, r = [], 0
    picked = np.zeros((0, V.shape[1]), dtype=np.int64)
    for i in range(V.shape[0]):
        cand = np.concatenate([picked, V[i:i + 1].astype(np.int64)])
        if REF_GF8.rank(cand) > r:
            picked, r = cand, r + 1
            idx.append(i)
            if r == M:
                break
    return idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_independent_rows_match_reference_choice(seed):
    rng = np.random.default_rng(seed)
    V = REF_GF8.random((20, 8), rng)
    V[:2, 7] = 0
    V[3] = V[1]                                   # a repeated row
    V[6] = REF_GF8.matmul(np.array([[5, 9]]), V[[0, 2]])[0]  # a combination
    V[9] = 0                                      # a zero row
    for limit in (8, 5, 20):
        got = independent_rows(GF8, V, limit)
        assert got == _reference_rows(V, limit)
    assert 3 not in independent_rows(GF8, V, 8)


def test_reconstruct_matches_reference(planes):
    ref, port, file_blocks, ref_nodes, port_nodes, _, _ = planes
    for ids in ([0, 1, 2], [5, 3, 1], [4, 2, 0, 1]):
        want = ref.reconstruct([ref_nodes[i] for i in ids], M)
        got = port.reconstruct([port_nodes[i] for i in ids], M)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), file_blocks)
        assert port.can_reconstruct([port_nodes[i] for i in ids], M)


def test_reconstruct_takes_part_of_a_node(planes):
    """A node with more rows than the decode needs gives only the rows
    taken (six combinations of four blocks: rank four)."""
    ref, port, file_blocks, ref_nodes, port_nodes, r1, r2 = planes
    extra_ref = ref.encode(ref_nodes[2], 6, r1)
    extra = port.encode(port_nodes[2], 6, r2)
    got = port.reconstruct([port_nodes[0], port_nodes[1], extra], M)
    want = ref.reconstruct([ref_nodes[0], ref_nodes[1], extra_ref], M)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), file_blocks)


def test_reconstruct_rank_deficient_raises(planes):
    ref, port, _, ref_nodes, port_nodes, r1, r2 = planes
    # two nodes hold 8 < M = 12 independent blocks
    assert not port.can_reconstruct(port_nodes[:2], M)
    assert not ref.can_reconstruct(ref_nodes[:2], M)
    with pytest.raises(ValueError, match="cannot reconstruct"):
        port.reconstruct(port_nodes[:2], M)
    with pytest.raises(ValueError, match="cannot reconstruct"):
        ref.reconstruct(ref_nodes[:2], M)
    # a node plus a copy of itself adds no rank
    dup = [port_nodes[0], port_nodes[0], port_nodes[1], port_nodes[2]]
    rdup = [ref_nodes[0], ref_nodes[0], ref_nodes[1], ref_nodes[2]]
    assert port.can_reconstruct(dup, M) == ref.can_reconstruct(rdup, M)
    np.testing.assert_array_equal(port.reconstruct(dup, M).numpy(),
                                  ref.reconstruct(rdup, M))


def test_custom_matmul_is_used(planes):
    _, _, file_blocks, _, _, _, _ = planes
    calls = []

    def mm(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        from repro_torch.kernels import gf_matmul_ref
        return gf_matmul_ref(a, b)

    rl = RLNC(GF8, matmul=mm, device="cpu")
    nodes = rl.distribute(torch.from_numpy(file_blocks), N_NODES, ALPHA,
                          np.random.default_rng(0))
    rl.reconstruct(nodes[:3], M)
    assert calls == [((N_NODES * ALPHA, M), (M, BLOCK)), ((M, M), (M, BLOCK))]


def test_coded_blocks_checks():
    with pytest.raises(ValueError):
        CodedBlocks(torch.zeros((2, 3), dtype=torch.uint8),
                    torch.zeros((3, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="GF"):
        RLNC(GF16, device="cpu")
