"""The port's erasure-coded checkpoints (``repro_torch.ft``) against
``repro.ft``, bit for bit.

Both sides hold the same state, built from the same numpy arrays (a bf16
leaf carried across as its 16-bit words), and take the same seeds for the
fleet, the coder and the checkpoint.  The port runs on CPU tensors (the
plain GF matmul).  Buffers, shards, providers, overlays, plans (scalar
planners on both sides, so times and betas compare with ``==``) and
regenerated shards must be equal, and every restore must give the state
back bit for bit.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.ft as ref_ft
import repro_torch.ft as port_ft
from repro_torch.ft import walkthrough
from repro_torch.ft.erasure import tree_flatten
from repro_torch.kernels import gf_matmul_cuda
from test_ft import make_state as ref_make_state

SCHEMES = ["star", "fr", "tr", "ftr", "auto"]


def to_port(tree):
    """The reference's state as the port's: the same structure, numpy and
    jax leaves as CPU tensors (bf16 through its 16-bit words)."""
    if isinstance(tree, dict):
        return type(tree)((k, to_port(v)) for k, v in tree.items())
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def same_tree(port_tree, ref_tree) -> bool:
    """Leaves equal in order, dtype width and bytes."""
    a, _ = tree_flatten(port_tree)
    b = jax.tree_util.tree_leaves(ref_tree)
    return len(a) == len(b) and all(
        tuple(x.shape) == np.shape(y) and leaf_bytes(x) == leaf_bytes(y)
        for x, y in zip(a, b))


def same_shard(port, ref):
    np.testing.assert_array_equal(port.vectors.numpy(), ref.vectors)
    np.testing.assert_array_equal(port.payload.numpy(), ref.payload)


def make_pair(seed=0, n=8, k=4, d=6, hosts=None, cfg=None):
    """A checkpoint of the same state in each package, same seeds."""
    cfg = cfg or {}
    hosts = list(range(n)) if hosts is None else hosts
    out = []
    for ft, kw in ((ref_ft, {}), (port_ft, {"device": "cpu"})):
        fleet = ft.Fleet(ft.FleetConfig(num_pods=2, hosts_per_pod=8, **cfg),
                         seed=seed)
        coder = ft.ErasureCoder(n=n, k=k, d=d, blocks_per_host=8, seed=seed,
                                **kw)
        out.append((fleet, ft.ECCheckpoint(fleet, coder, hosts=hosts,
                                           seed=seed)))
    state = ref_make_state(seed)
    out[0][1].save(state, step=7)
    out[1][1].save(to_port(state), step=7)
    return out[0], out[1], state


def assert_groups_equal(port_ck, ref_ck):
    pg, rg = port_ck.group, ref_ck.group
    assert (pg.block_bytes, pg.payload_bytes) == (rg.block_bytes,
                                                  rg.payload_bytes)
    assert sorted(pg.shards) == sorted(rg.shards)
    for h in rg.shards:
        same_shard(pg.shards[h], rg.shards[h])


def assert_logs_equal(port_log, ref_log):
    pd, rd = port_log.decision, ref_log.decision
    assert pd.providers == rd.providers and pd.newcomer == rd.newcomer
    assert pd.overlay.cap == rd.overlay.cap
    assert pd.alternatives == rd.alternatives
    assert pd.predicted_s == rd.predicted_s
    pp, rp = pd.plan, rd.plan
    assert (pp.scheme, pp.parent, pp.betas, pp.flows, pp.time) == \
        (rp.scheme, rp.parent, rp.betas, rp.flows, rp.time)
    pr, rr = port_log.report, ref_log.report
    assert (pr.regenerated_host, pr.blocks_moved, pr.predicted_s,
            pr.per_edge_s) == (rr.regenerated_host, rr.blocks_moved,
                               rr.predicted_s, rr.per_edge_s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_to_bytes_matches_reference(seed):
    """Byte for byte, with the reference's sorted key order (the state's
    dicts are not built in sorted order) and an OrderedDict kept in
    insertion order."""
    state = ref_make_state(seed)
    state["opt"]["zz_ordered"] = collections.OrderedDict(
        [("z", np.arange(3, dtype=np.int16)), ("a", np.float64(2.5))])
    state["none"] = None
    want, ref_spec = ref_ft.tree_to_bytes(state)
    got, spec = port_ft.tree_to_bytes(to_port(state), device="cpu")
    assert got.dtype == torch.uint8 and got.numpy().tobytes() == want.tobytes()
    assert spec.total_bytes == ref_spec.total_bytes
    assert spec.sizes == ref_spec.sizes
    back = port_ft.bytes_to_tree(got, spec)
    assert same_tree(back, state)
    assert back["none"] is None
    assert isinstance(back["opt"]["zz_ordered"], collections.OrderedDict)
    assert list(back["opt"]["zz_ordered"]) == ["z", "a"]


def test_tree_to_bytes_pads_to_blocks():
    state = to_port(ref_make_state(4))
    flat, spec = port_ft.tree_to_bytes(state, device="cpu")
    padded, spec2 = port_ft.tree_to_bytes(state, device="cpu", blocks=64)
    assert len(padded) % 64 == 0 and len(padded) - 64 < spec.total_bytes
    assert spec2.total_bytes == spec.total_bytes == len(flat)
    assert torch.equal(padded[:len(flat)], flat)
    assert not padded[len(flat):].any()


def test_bytes_to_tree_odd_offsets():
    """Leaves at offsets that are no multiple of their element size come
    back as copies, equal to the originals; aligned ones as views."""
    state = {"a": torch.tensor([7], dtype=torch.uint8),
             "b": torch.randn(5, dtype=torch.float32).to(torch.bfloat16),
             "c": torch.arange(6, dtype=torch.float64).reshape(2, 3),
             "d": torch.tensor(True),
             "e": torch.tensor(-3, dtype=torch.int32)}
    buf, spec = port_ft.tree_to_bytes(state, device="cpu")
    assert [s for s in spec.sizes] == [1, 10, 48, 1, 4]
    back = port_ft.bytes_to_tree(buf, spec)
    for key, leaf in state.items():
        assert back[key].dtype == leaf.dtype and back[key].shape == leaf.shape
        assert leaf_bytes(back[key]) == leaf_bytes(leaf)
    # "a" starts at 0: a view of the buffer
    assert back["a"].data_ptr() == buf.data_ptr()
    # from an odd offset into a larger buffer too
    shifted = torch.cat([torch.zeros(1, dtype=torch.uint8), buf])[1:]
    again = port_ft.bytes_to_tree(shifted, spec)
    assert all(leaf_bytes(again[k]) == leaf_bytes(v) for k, v in state.items())


def test_restored_buffer_freed_without_the_collector():
    """A restore's buffer goes when its tree goes, by reference counting:
    no reference cycle keeps it (at full width it is 12 GB of the card)."""
    import gc
    import weakref
    (_, _), (_, port_ck), _ = make_pair(seed=6)
    gc.collect()
    gc.disable()
    try:
        restored = port_ck.restore([0, 2, 4, 6])
        base = weakref.ref(restored["opt"]["m"]._base)
        del restored
        assert base() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("seed", [0, 5])
def test_encode_matches_reference(seed):
    (_, ref_ck), (_, port_ck), state = make_pair(seed)
    assert_groups_equal(port_ck, ref_ck)
    for hosts in ([0, 1, 2, 3], [4, 5, 6, 7], [1, 3, 5, 7]):
        assert same_tree(port_ck.restore(hosts), state)
    np.testing.assert_array_equal(
        port_ck.coder.reconstruct(port_ck.group, [2, 3, 6, 7]).numpy(),
        ref_ck.coder.reconstruct(ref_ck.group, [2, 3, 6, 7]))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_failure_regeneration_matches_reference(scheme):
    (_, ref_ck), (_, port_ck), state = make_pair(seed=3)
    gf_matmul_cuda.launches = 0
    rlog = ref_ck.on_host_failure(2, scheme=scheme)
    plog = port_ck.on_host_failure(2, scheme=scheme)
    assert gf_matmul_cuda.launches == 0          # CPU tensors: plain version
    assert_logs_equal(plog, rlog)
    assert_groups_equal(port_ck, ref_ck)
    assert np.isfinite(plog.decision.predicted_s) and plog.wall_s >= 0
    for hosts in ([2, 4, 6, 7], [0, 1, 2, 5], [0, 1, 3, 4]):
        assert same_tree(port_ck.restore(hosts), state)


def test_repeated_failures_preserve_mds():
    (_, ref_ck), (_, port_ck), state = make_pair(seed=5)
    for failed in (1, 6, 3, 1, 0):
        assert_logs_equal(port_ck.on_host_failure(failed, scheme="ftr"),
                          ref_ck.on_host_failure(failed, scheme="ftr"))
    assert_groups_equal(port_ck, ref_ck)
    assert same_tree(port_ck.restore([0, 1, 3, 6]), state)
    assert same_tree(port_ck.restore([2, 4, 5, 7]), state)


def test_elastic_reshard():
    (_, ref_ck), (_, port_ck), state = make_pair(seed=13)
    ref2 = ref_ck.reshard(ref_ft.ErasureCoder(n=6, k=3, d=4,
                                              blocks_per_host=8, seed=99),
                          new_hosts=[8, 9, 10, 11, 12, 13])
    port2 = port_ck.reshard(port_ft.ErasureCoder(n=6, k=3, d=4,
                                                 blocks_per_host=8, seed=99,
                                                 device="cpu"),
                            new_hosts=[8, 9, 10, 11, 12, 13])
    assert_groups_equal(port2, ref2)
    assert same_tree(port2.restore([9, 11, 13]), state)
    assert_logs_equal(port2.on_host_failure(10, scheme="ftr"),
                      ref2.on_host_failure(10, scheme="ftr"))
    assert_groups_equal(port2, ref2)
    assert same_tree(port2.restore([8, 10, 12]), state)


def test_replacement_host_id():
    (_, ref_ck), (_, port_ck), state = make_pair(seed=17)
    assert_logs_equal(port_ck.on_host_failure(5, replacement=15, scheme="ftr"),
                      ref_ck.on_host_failure(5, replacement=15, scheme="ftr"))
    assert 15 in port_ck.group.shards and 5 not in port_ck.group.shards
    assert port_ck.hosts == ref_ck.hosts
    assert_groups_equal(port_ck, ref_ck)
    assert same_tree(port_ck.restore([15, 0, 1, 2]), state)


def test_straggler_rerouting():
    """A hard straggler among the providers carries no more than its fair
    share under FR, as in the reference, with the same decision."""
    (ref_fleet, ref_ck), (port_fleet, port_ck), _ = make_pair(seed=11)
    for fleet in (ref_fleet, port_fleet):
        fleet.straggle.clear()
        fleet.mark_straggler(1, 0.02)
    rlog = ref_ck.on_host_failure(0, scheme="fr")
    plog = port_ck.on_host_failure(0, scheme="fr")
    assert_logs_equal(plog, rlog)
    decision = plog.decision
    assert 1 in decision.providers
    i = decision.providers.index(1) + 1
    betas = decision.plan.betas
    assert betas[i - 1] <= sum(betas) / len(betas) + 1e-9


def test_ftr_beats_or_matches_star_prediction():
    (_, ref_ck), (_, port_ck), _ = make_pair(seed=9)
    plog = port_ck.on_host_failure(4, scheme="auto")
    assert_logs_equal(plog, ref_ck.on_host_failure(4, scheme="auto"))
    alts = plog.decision.alternatives
    assert alts["ftr"] <= alts["star"] + 1e-9
    assert plog.decision.predicted_s <= min(alts.values()) + 1e-9


def test_jax_state_with_bf16_leaf():
    """The reference's state holds a jnp bf16 array; the port's the same
    bits as a torch bf16 tensor: the same bytes either way."""
    state = ref_make_state(0)
    assert state["params"]["b"].dtype == jnp.bfloat16
    port = to_port(state)
    assert port["params"]["b"].dtype == torch.bfloat16
    assert leaf_bytes(port["params"]["b"]) == leaf_bytes(state["params"]["b"])


def test_walkthrough_runs_at_the_smoke_config(capsys):
    assert walkthrough.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "restored bit-identically" in out and "<- chosen" in out
