"""The port's coded data plane against ``repro.fleet.dataplane``.

The data plane's store is the port's ``RlncSimulator`` on the simulator's
device (here the CPU, so the plain GF(2^8) matmul; on the card the
kernel).  From the same fleet seed it draws the reference's stream draw
for draw, so after a fleet run its node states, read back through
``storage.convert``, equal the reference store's bit for bit.  The
wire-byte ledgers are host floats: equal with ``engine="scalar"``, within
1e-9 relative at the default engine.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.fleet as ref_fleet
import repro_torch.core as port_core
import repro_torch.fleet as port_fleet
from repro_torch.fleet import dataplane as port_dataplane
from repro_torch.kernels import gf_matmul_ref
from repro_torch.obs import spans
from repro_torch.storage import to_reference_state

P = dict(n=12, k=3, d=6, M=600.0)
REF_PARAMS = ref_core.CodeParams.msr(**P)
PORT_PARAMS = port_core.CodeParams.msr(**P)
SMALL = dict(n=6, k=2, d=3, M=4.0)      # alpha = 2: mini-store scale 1


def _storm(pkg, duration, n=16, lam=2e-3, **over):
    """fleet_scale's data-plane storm row: hot reads with the plane and
    decode checks on, under fast and deep capacity shocks."""
    return dataclasses.replace(
        pkg.SCENARIOS["hot_reads"](n, failure_rate=lam, duration=duration,
                                   dataplane=True, dataplane_verify=True),
        shock_period=duration / 8, shock_lo=0.35, **over)


def _config_seed(root_seed, name):
    return (root_seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 31)


def _assert_store_bitwise(port_store, ref_store):
    file_blocks, nodes, np_state, py_state = to_reference_state(port_store)
    np.testing.assert_array_equal(file_blocks, ref_store.file_blocks)
    assert sorted(nodes) == sorted(ref_store.nodes)
    for i, (vec, pay) in nodes.items():
        np.testing.assert_array_equal(vec, ref_store.nodes[i].vectors)
        np.testing.assert_array_equal(pay, ref_store.nodes[i].payload)
    assert np_state == ref_store.np_rng.bit_generator.state
    assert py_state == ref_store.rng.getstate()


def _run_both(ref_sc, port_sc, policy, engine, seed, ref_params=REF_PARAMS,
              port_params=PORT_PARAMS):
    ref = ref_fleet.FleetSimulator(
        ref_sc, ref_fleet.make_policy(policy, engine=engine), ref_params,
        seed=seed)
    port = port_fleet.FleetSimulator(
        port_sc, port_fleet.make_policy(policy, engine=engine), port_params,
        seed=seed, device="cpu")
    return port, port.run().summary(), ref, ref.run().summary()


def test_storm_row_default_engine():
    """The golden sweep's quick storm row (fleet_scale's
    ``dataplane_hot_reads_storm_n16_flexible``), planned by the tier."""
    name = "dataplane_hot_reads_storm_n16_flexible"
    duration = 40 / (2e-3 * 16)
    launches = spans.total("gf.launches")
    port, got, ref, expect = _run_both(
        _storm(ref_fleet, duration), _storm(port_fleet, duration),
        "flexible", "auto", _config_seed(0, name))
    assert got["decode_failures"] == 0 and expect["decode_failures"] == 0
    assert got["decode_checks"] == got["completed"] > 0
    assert got["reads_completed"] > 0 and got["repair_bytes"] > 0
    for key, e in expect.items():
        if isinstance(e, int):
            assert got[key] == e, key
        elif key.startswith("plan_err"):    # ratios less one: ROADMAP C6
            assert abs(got[key] - e) <= 16 * np.finfo(np.float64).eps \
                * abs(1.0 + e), key
        else:
            assert got[key] == pytest.approx(e, rel=1e-9, abs=0.0), key
    port_top = port.dataplane.top_links(10)
    ref_top = ref.dataplane.top_links(10)
    assert [name for name, _ in port_top] == [name for name, _ in ref_top]
    for (_, p), (_, r) in zip(port_top, ref_top):
        for key in ("repair_bytes", "read_bytes"):
            assert p[key] == pytest.approx(r[key], rel=1e-9, abs=0.0)
    _assert_store_bitwise(port.dataplane.store, ref.dataplane.store)
    assert spans.total("gf.launches") == launches == 0


def test_storm_scalar_engine_bitwise():
    port, got, ref, expect = _run_both(
        _storm(ref_fleet, 300.0), _storm(port_fleet, 300.0), "flexible",
        "scalar", seed=5)
    assert expect["decode_checks"] > 0 and expect["reads_completed"] > 0
    assert got == expect
    assert port.dataplane.top_links(10) == ref.dataplane.top_links(10)
    assert port.dataplane.snapshot() == ref.dataplane.snapshot()
    _assert_store_bitwise(port.dataplane.store, ref.dataplane.store)


def test_read_trace_replay(tmp_path):
    """One ``generate_trace`` file per package, byte for byte equal, each
    replayed by its own package's simulator."""
    duration = 500.0
    paths = {}
    for tag, pkg in (("ref", ref_fleet), ("port", port_fleet)):
        paths[tag] = tmp_path / f"{tag}.jsonl"
        count = pkg.generate_trace(str(paths[tag]), rate=0.1,
                                   duration=duration, seed=3, chunk=7)
        assert count > 0
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()

    def scenario(pkg, path):
        return pkg.SCENARIOS["hot_reads"](
            16, duration=duration, dataplane=True, dataplane_verify=True,
            read_trace=pkg.ReadTrace(path=str(path)))

    port, got, ref, expect = _run_both(
        scenario(ref_fleet, paths["ref"]), scenario(port_fleet,
                                                    paths["port"]),
        "ftr", "scalar", seed=8)
    assert expect["reads_completed"] > 0
    assert got == expect
    _assert_store_bitwise(port.dataplane.store, ref.dataplane.store)


@pytest.mark.parametrize("mode", ["numpy", "kernel", "auto"])
def test_matmul_modes_give_the_reference_store(mode):
    """Every backend name gives the reference's blocks (its log/antilog
    tables); on CPU tensors "kernel" and "auto" are the plain version and
    nothing reaches the kernel."""
    kw = dict(num_nodes=6, duration=150.0, failure_rate=0.0,
              failures=((5.0, 0), (40.0, 3), (90.0, 1)), dataplane=True,
              dataplane_verify=True)
    caps = np.full((6, 6), 4.0)
    np.fill_diagonal(caps, 0.0)
    port, got, ref, expect = _run_both(
        ref_fleet.Scenario(capacity_model=lambda rng, m: caps.copy(),
                           dataplane_matmul="numpy", **kw),
        port_fleet.Scenario(capacity_model=lambda rng, m: caps.copy(),
                            dataplane_matmul=mode, **kw),
        "flexible", "scalar", seed=7,
        ref_params=ref_core.CodeParams.msr(**SMALL),
        port_params=port_core.CodeParams.msr(**SMALL))
    assert got == expect and got["decode_failures"] == 0
    assert got["decode_checks"] == 3
    _assert_store_bitwise(port.dataplane.store, ref.dataplane.store)
    store = port.dataplane.store
    expected = (port_dataplane._host_matmul if mode == "numpy"
                else port_dataplane.gf_matmul)
    assert store.rl._matmul is expected
    # the regenerated nodes still reconstruct the file
    combo = [store.nodes[i] for i in (0, 3)]
    got_file = store.rl.reconstruct(combo, int(port.dataplane.mini.M))
    assert torch.equal(got_file, store.file_blocks)
    assert spans.total("gf.launches") == 0


def test_numpy_matmul_refused_on_a_card_store():
    """A store on the card multiplies with the kernel: the host tables
    would copy every product's operands off the card."""
    resolve = port_dataplane.DataPlane._resolve_matmul
    with pytest.raises(ValueError, match="CPU store only"):
        resolve("numpy", torch.device("cuda", 0))
    for mode in ("kernel", "auto"):
        assert resolve(mode, torch.device("cuda", 0)) is port_dataplane.gf_matmul
    assert resolve("numpy", torch.device("cpu")) is port_dataplane._host_matmul


def test_host_matmul_matches_plain_version():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (5, 9), dtype=np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (9, 33), dtype=np.uint8))
    assert torch.equal(port_dataplane._host_matmul(a, b), gf_matmul_ref(a, b))


def test_dataplane_blocks_must_divide_by_k():
    sc = port_fleet.Scenario(num_nodes=16, duration=10.0, dataplane=True,
                             dataplane_blocks=4)
    with pytest.raises(ValueError, match="divisible by k=3"):
        port_fleet.FleetSimulator(sc, port_fleet.make_policy("star"),
                                  PORT_PARAMS, device="cpu")


def test_store_lives_on_the_simulator_device():
    sc = _storm(port_fleet, 50.0, dataplane_payload_bytes=24)
    sim = port_fleet.FleetSimulator(sc, port_fleet.make_policy("star"),
                                    PORT_PARAMS, device="cpu")
    store = sim.dataplane.store
    assert store.device == sim.device == torch.device("cpu")
    assert store.file_blocks.shape == (6, 24)
    assert all(nd.payload.shape == (2, 24) for nd in store.nodes.values())
