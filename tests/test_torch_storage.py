"""The slice as a whole: the port's storage simulator against
``repro.storage``, bit for bit.

From one seed, the port's ``RlncSimulator`` (on CPU tensors, the plain GF
matmul) and the reference's simulator on the same engine must hold equal
node states after every repair round of every scheme, give the same Fig. 10
curve, and, after a state handover, continue as the reference would.  The
port's batched engine (the planning tier, run on the CPU) is held against
the reference's default batched engine: plans within 1e-9, node states bit
for bit (the executor rounds quotas up, so 1e-9 cannot change a draw).
"""
import random
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.storage as ref_storage
import repro_torch.core as port_core
import repro_torch.storage as port_storage

SCHEMES = ("star", "fr", "tr", "ftr", "rctree", "shah")
# fig10_rctree.py's first setting, an MSR code with d = k + 2, and an
# interior point (alpha between MSR and MBR is not integral here, so above)
SETTINGS = [dict(n=8, k=2, d=4, M=6.0, alpha=3.0),
            dict(n=8, k=3, d=5, M=9.0, alpha=3.0),
            dict(n=8, k=2, d=4, M=6.0, alpha=4.0)]


def _assert_same_state(port_sim, ref_sim, msg=""):
    assert sorted(port_sim.nodes) == sorted(ref_sim.nodes)
    for i, nd in ref_sim.nodes.items():
        np.testing.assert_array_equal(port_sim.nodes[i].vectors.numpy(),
                                      nd.vectors, err_msg=f"{msg} node {i}")
        np.testing.assert_array_equal(port_sim.nodes[i].payload.numpy(),
                                      nd.payload, err_msg=f"{msg} node {i}")
    np.testing.assert_array_equal(port_sim.file_blocks.numpy(),
                                  ref_sim.file_blocks)
    assert port_sim.np_rng.bit_generator.state == \
        ref_sim.np_rng.bit_generator.state
    assert port_sim.rng.getstate() == ref_sim.rng.getstate()


def _sims(setting, seed, block_bytes=16, engine="scalar"):
    ref = ref_storage.RlncSimulator(ref_core.CodeParams(**setting),
                                    block_bytes=block_bytes, seed=seed,
                                    engine=engine)
    port = port_storage.RlncSimulator(port_core.CodeParams(**setting),
                                      block_bytes=block_bytes, seed=seed,
                                      device="cpu", engine=engine)
    return port, ref


def _close(a, b, msg):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=1e-9,
                               atol=1e-9, err_msg=msg)


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["n8k2d4", "n8k3d5", "n8k2d4-alpha4"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_repair_rounds_bitwise(scheme, setting):
    port, ref = _sims(setting, seed=5)
    _assert_same_state(port, ref, "after distribute")
    for r in range(3):
        pp = port.repair_round(scheme, port_storage.uniform())
        rp = ref.repair_round(scheme, ref_storage.uniform())
        assert pp.parent == rp.parent and pp.betas == rp.betas
        _assert_same_state(port, ref, f"{scheme} round {r}")
    assert port.reconstruction_probability() == \
        ref.reconstruction_probability()
    assert port.reconstruction_probability(samples=6) == \
        ref.reconstruction_probability(samples=6)
    assert port.rng.getstate() == ref.rng.getstate()


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["n8k2d4", "n8k3d5", "n8k2d4-alpha4"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_repair_rounds_bitwise_batched(scheme, setting):
    port, ref = _sims(setting, seed=5, engine="batched")
    for r in range(3):
        pp = port.repair_round(scheme, port_storage.uniform())
        rp = ref.repair_round(scheme, ref_storage.uniform())
        assert pp.parent == rp.parent
        _close(pp.betas, rp.betas, f"{scheme} round {r}")
        _assert_same_state(port, ref, f"{scheme} round {r}")
    assert port.reconstruction_probability(samples=6) == \
        ref.reconstruction_probability(samples=6)


def test_every_scheme_in_turn_on_one_store():
    port, ref = _sims(SETTINGS[1], seed=9, block_bytes=40)
    for scheme in SCHEMES:
        port.repair_round(scheme, port_storage.uniform(1.0, 50.0))
        ref.repair_round(scheme, ref_storage.uniform(1.0, 50.0))
    _assert_same_state(port, ref, "mixed schemes")
    ids = [0, 3, 6]
    got = port.rl.reconstruct([port.nodes[i] for i in ids], 9)
    np.testing.assert_array_equal(
        got.numpy(), ref.rl.reconstruct([ref.nodes[i] for i in ids], 9))


@pytest.mark.parametrize("scheme", ["ftr", "rctree"])
def test_fig10_curve_matches_reference(scheme):
    """benchmarks/fig10_rctree.py's first setting, n=8 k=2 d=4 M=6."""
    kw = dict(rounds=4, trials=2, seed=10)
    want = ref_storage.reconstruction_vs_rounds(
        ref_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
        ref_storage.uniform(), engine="scalar", **kw)
    got = port_storage.reconstruction_vs_rounds(
        port_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
        port_storage.uniform(), engine="scalar", device="cpu", **kw)
    assert got == want
    sub = dict(kw, subset_samples=7)
    assert port_storage.reconstruction_vs_rounds(
        port_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
        port_storage.uniform(), engine="scalar", device="cpu", **sub) == \
        ref_storage.reconstruction_vs_rounds(
            ref_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
            ref_storage.uniform(), engine="scalar", **sub)


@pytest.mark.parametrize("scheme", ["ftr", "fr", "rctree"])
@pytest.mark.parametrize("subset_samples", [0, 7])
def test_fig10_curve_matches_reference_batched(scheme, subset_samples):
    """The default engines of both (the bulk path at subset_samples=0 for
    the schemes with a batched planner), bit for bit."""
    kw = dict(rounds=4, trials=2, seed=10, subset_samples=subset_samples)
    want = ref_storage.reconstruction_vs_rounds(
        ref_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
        ref_storage.uniform(), **kw)
    got = port_storage.reconstruction_vs_rounds(
        port_core.CodeParams.msr(n=8, k=2, d=4, M=6.0), scheme,
        port_storage.uniform(), device="cpu", **kw)
    assert got == want


def _plan_rounds_then_execute(engine, same_betas):
    port, ref = _sims(SETTINGS[0], seed=3, engine=engine)
    pr = port.plan_rounds("fr", port_storage.uniform(), 3)
    rr = ref.plan_rounds("fr", ref_storage.uniform(), 3)
    for (pf, pprov, ppl), (rf, rprov, rpl) in zip(pr, rr):
        assert (pf, pprov, ppl.parent) == (rf, rprov, rpl.parent)
        same_betas(ppl.betas, rpl.betas)
        port.execute_plan(ppl, pf, pprov)
        ref.execute_plan(rpl, rf, rprov)
    _assert_same_state(port, ref, "plan_rounds")


def test_plan_rounds_then_execute():
    def equal(a, b):
        assert a == b
    _plan_rounds_then_execute("scalar", equal)


def test_plan_rounds_then_execute_batched():
    _plan_rounds_then_execute(
        "batched", lambda a, b: _close(a, b, "plan_rounds"))


@pytest.mark.parametrize("scheme", ["ftr", "tr"])
def test_state_handover_continues_like_reference(scheme):
    setting = SETTINGS[0]
    params = port_core.CodeParams(**setting)
    ref = ref_storage.RlncSimulator(ref_core.CodeParams(**setting),
                                    block_bytes=24, seed=4, engine="scalar")
    for _ in range(2):
        ref.repair_round(scheme, ref_storage.uniform())
    nodes = {i: (nd.vectors, nd.payload) for i, nd in ref.nodes.items()}
    port = port_storage.from_reference_state(
        params, ref.file_blocks, nodes, ref.np_rng.bit_generator.state,
        ref.rng.getstate(), device="cpu", engine="scalar")
    _assert_same_state(port, ref, "handover")
    for r in range(3):
        port.repair_round(scheme, port_storage.uniform())
        ref.repair_round(scheme, ref_storage.uniform())
        _assert_same_state(port, ref, f"continued round {r}")

    # and back: a reference simulator given the port's state continues too
    file_blocks, nodes, np_state, py_state = \
        port_storage.to_reference_state(port)
    back = ref_storage.RlncSimulator(ref_core.CodeParams(**setting),
                                     block_bytes=24, seed=99, engine="scalar")
    back.file_blocks = file_blocks
    back.nodes = {i: ref_storage.simulator.CodedBlocks(v, p)
                  for i, (v, p) in nodes.items()}
    back.np_rng.bit_generator.state = np_state
    back.rng.setstate(py_state)
    port.repair_round(scheme, port_storage.uniform())
    back.repair_round(scheme, ref_storage.uniform())
    _assert_same_state(port, back, "returned")


def test_compare_schemes_matches_reference_scalar():
    rp = ref_core.CodeParams.msr(n=12, k=3, d=6, M=600.0)
    pp = port_core.CodeParams.msr(n=12, k=3, d=6, M=600.0)
    schemes = ("star", "fr", "tr", "ftr", "shah", "rctree")
    want = ref_storage.compare_schemes(rp, ref_storage.uniform(), schemes,
                                       trials=4, seed=5, engine="scalar")
    got = port_storage.compare_schemes(pp, port_storage.uniform(), schemes,
                                       trials=4, seed=5, engine="scalar")
    for s in schemes:
        w, g = want[s], got[s]
        assert (g.mean_time, g.mean_norm_time, g.mean_traffic,
                g.mean_norm_traffic, g.engine) == \
            (w.mean_time, w.mean_norm_time, w.mean_traffic,
             w.mean_norm_traffic, w.engine)


@pytest.mark.parametrize("interior", [False, True], ids=["msr", "interior"])
def test_compare_schemes_matches_reference_batched(interior):
    """Both default (batched) engines, every trial planned in one call:
    the statistics within 1e-9 (``plan_seconds`` is wall time, left out);
    rctree falls back to the scalar planner in both, with the warning."""
    a_mbr = ref_core.mbr_point(600.0, 3, 6)[0]
    alpha = 0.5 * (200.0 + a_mbr) if interior else 200.0
    rp = ref_core.CodeParams(n=12, k=3, d=6, M=600.0, alpha=alpha)
    pp = port_core.CodeParams(n=12, k=3, d=6, M=600.0, alpha=alpha)
    schemes = ("star", "fr", "tr", "ftr", "shah", "rctree")
    with warnings.catch_warnings():     # rctree's once-per-scheme warning
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref_storage.compare_schemes(rp, ref_storage.uniform(),
                                           schemes, trials=12, seed=5)
        got = port_storage.compare_schemes(pp, port_storage.uniform(),
                                           schemes, trials=12, seed=5,
                                           device="cpu")
    for s in schemes:
        w, g = want[s], got[s]
        assert g.engine == w.engine == ("scalar" if s == "rctree"
                                        else "batched")
        _close([g.mean_time, g.mean_norm_time, g.mean_traffic,
                g.mean_norm_traffic],
               [w.mean_time, w.mean_norm_time, w.mean_traffic,
                w.mean_norm_traffic], s)


def test_capacity_samplers_draw_like_reference():
    for name, sampler in port_storage.FIG7_DISTRIBUTIONS.items():
        r1, r2 = random.Random(3), random.Random(3)
        assert sampler(r1, 6).cap == \
            ref_storage.FIG7_DISTRIBUTIONS[name](r2, 6).cap
    np.testing.assert_array_equal(
        port_storage.uniform_matrix()(np.random.default_rng(1), 7),
        ref_storage.uniform_matrix()(np.random.default_rng(1), 7))


def test_simulator_needs_integral_blocks():
    with pytest.raises(ValueError, match="integral"):
        port_storage.RlncSimulator(
            port_core.CodeParams.msr(n=8, k=3, d=4, M=10.0), device="cpu")
