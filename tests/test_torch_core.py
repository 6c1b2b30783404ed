"""The port's scalar planners and registry against ``repro.core``.

Seeded overlays as in ``tests/test_jax_engine.py`` (msr and interior
params, d in {4, 6}, plus the Fig. 7 fan-out d = 10).  The cross-engine
contract of the reference (``src/README.md``, engine matrix): tree
``parent`` is exact, and times, betas and flows agree within 1e-9
relative.  The port copies the reference's float arithmetic, so in
practice they are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro_torch.core as port_core

REL_TOL = 1e-9
SCHEMES = ("star", "fr", "tr", "ftr", "rctree", "shah")


def _caps(seed: int, B: int, d: int, lo=10.0, hi=120.0) -> np.ndarray:
    rng = np.random.default_rng([seed, 0x1A2])
    caps = rng.uniform(lo, hi, size=(B, d + 1, d + 1))
    idx = np.arange(d + 1)
    caps[:, idx, idx] = 0.0
    return caps


def _params(core, d: int, k: int, interior: bool):
    M = 600.0
    if not interior:
        return core.CodeParams.msr(n=d + 2, k=k, d=d, M=M)
    a_mbr, _ = core.mbr_point(M, k, d)
    return core.CodeParams(n=d + 2, k=k, d=d, M=M,
                           alpha=0.5 * (M / k + a_mbr))


def _close(a, b, msg):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float),
                               rtol=REL_TOL, atol=REL_TOL, err_msg=msg)


def _same_plan(got, want, msg):
    assert got.scheme == want.scheme, msg
    assert got.parent == want.parent, f"{msg}: parent"
    _close(got.time, want.time, f"{msg}: time")
    _close(got.betas, want.betas, f"{msg}: betas")
    assert set(got.flows) == set(want.flows), f"{msg}: flow edges"
    _close([got.flows[e] for e in want.flows], list(want.flows.values()),
           f"{msg}: flows")
    assert (got.lower_bound is None) == (want.lower_bound is None), msg
    if want.lower_bound is not None:
        _close(got.lower_bound, want.lower_bound, f"{msg}: lower bound")


CASES = [(4, 2, False), (4, 2, True), (6, 3, False), (6, 3, True),
         (10, 5, False)]


@pytest.mark.parametrize("d,k,interior", CASES,
                         ids=[f"d{d}k{k}{'-interior' if i else '-msr'}"
                              for d, k, i in CASES])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scalar_planners_match_reference(scheme, d, k, interior):
    rp = _params(ref_core, d, k, interior)
    pp = _params(port_core, d, k, interior)
    B = 3 if d == 10 else 6
    for b, c in enumerate(_caps(7 + d + interior, B, d)):
        want = ref_core.plan(ref_core.OverlayNetwork(c.tolist()), rp, scheme,
                             engine="scalar")
        net = port_core.OverlayNetwork(c.tolist())
        got = port_core.plan(net, pp, scheme)
        _same_plan(got, want, f"{scheme} row {b}")
        if scheme != "rctree":      # rctree's fixed-beta flows break MDS
            got.validate(net)


@pytest.mark.parametrize("scheme", ["fr", "ftr"])
@pytest.mark.parametrize("interior", [False, True], ids=["msr", "interior"])
def test_lp_witness_matches_reference(scheme, interior):
    rp = _params(ref_core, 6, 3, interior)
    pp = _params(port_core, 6, 3, interior)
    for b, c in enumerate(_caps(21 + interior, 3, 6)):
        want = ref_core.plan(ref_core.OverlayNetwork(c.tolist()), rp, scheme,
                             engine="scalar", witness="lp")
        got = port_core.plan(port_core.OverlayNetwork(c.tolist()), pp, scheme,
                             witness="lp")
        _same_plan(got, want, f"{scheme}/lp row {b}")


def test_plan_many_matches_reference_scalar_batch():
    """The scalar engine's packed batch: every field of the reference's
    ``plan_many(engine="scalar")``, on the CPU, with the plans alongside."""
    rp = _params(ref_core, 6, 3, True)
    pp = _params(port_core, 6, 3, True)
    caps = _caps(5, 5, 6)
    nets = [port_core.OverlayNetwork(c.tolist()) for c in caps]
    for s in SCHEMES:
        want = ref_core.plan_many(caps, rp, s, engine="scalar")
        got = port_core.plan_many(nets, pp, s, engine="scalar")
        assert (got.scheme, got.engine) == (want.scheme, want.engine)
        for f in ("times", "traffic", "betas", "parents", "lower_bounds"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f"{s}: {f}"
            if w is not None:
                assert g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{s}: {f}")
        assert len(got.plans) == len(want.plans) == 5
        for b, (g, w) in enumerate(zip(got.plans, want.plans)):
            _same_plan(g, w, f"{s} row {b}")
        again = port_core.plan_many(iter(nets), pp, s, engine="scalar")
        assert [p.time for p in again.plans] == [p.time for p in got.plans]
        assert port_core.plans_from_batch(got, pp) == got.plans


def test_registry_mirrors_reference():
    assert port_core.scheme_names() == ref_core.scheme_names()
    for s in SCHEMES:
        assert (port_core.get_scheme(s).accepts_witness
                == ref_core.get_scheme(s).accepts_witness)
        assert ((port_core.get_scheme(s).batched is None)
                == (ref_core.get_scheme(s).batched is None))


def test_register_and_unregister():
    """A registered scheme plans through ``plan``; a second registration of
    the name raises.  The test takes its scheme out of the registry again
    so that the other tests see the built-in set."""
    from repro_torch.core import api

    @port_core.register_scheme("star_copy")
    def plan_star_copy(net, params):
        return port_core.plan_star(net, params)

    try:
        assert port_core.scheme_names()[-1] == "star_copy"
        assert port_core.get_scheme("star_copy").scalar is plan_star_copy
        with pytest.raises(ValueError, match="already registered"):
            port_core.register_scheme("star_copy", plan_star_copy)
        pp = _params(port_core, 4, 2, False)
        net = port_core.OverlayNetwork(_caps(3, 1, 4)[0].tolist())
        assert (port_core.plan(net, pp, "star_copy").time
                == port_core.plan(net, pp, "star").time)
    finally:
        del api._REGISTRY["star_copy"]
    assert "star_copy" not in port_core.scheme_names()


@pytest.mark.parametrize("M,k,d,alpha", [(600.0, 3, 6, 200.0),
                                         (600.0, 3, 6, 260.0),
                                         (960.0, 5, 10, 192.0)])
def test_params_helpers(M, k, d, alpha):
    assert port_core.uniform_beta(M, k, d, alpha) == \
        ref_core.uniform_beta(M, k, d, alpha)
    assert port_core.msr_point(M, k, d) == ref_core.msr_point(M, k, d)
    assert port_core.mbr_point(M, k, d) == ref_core.mbr_point(M, k, d)
    pp = port_core.CodeParams(n=d + 2, k=k, d=d, M=M, alpha=alpha)
    rp = ref_core.CodeParams(n=d + 2, k=k, d=d, M=M, alpha=alpha)
    assert port_core.heuristic_region(pp).x == ref_core.heuristic_region(rp).x


# ---------------------------------------------------------------------------
# Host oracles: brute-force ORT, the information flow graph, extensions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,k", [(3, 2), (4, 2)])
def test_ort_matches_reference(d, k):
    """The exhaustive tree search is exact at d <= 4: same trees, same
    plans."""
    assert list(port_core.iter_rooted_trees(d)) == \
        list(ref_core.iter_rooted_trees(d))
    for interior in (False, True):
        rp = _params(ref_core, d, k, interior)
        pp = _params(port_core, d, k, interior)
        for b, c in enumerate(_caps(50 + d, 2, d)):
            for name in ("plan_ort_uniform", "plan_ort_flexible"):
                want = getattr(ref_core, name)(
                    ref_core.OverlayNetwork(c.tolist()), rp)
                got = getattr(port_core, name)(
                    port_core.OverlayNetwork(c.tolist()), pp)
                _same_plan(got, want, f"{name} row {b}")


@pytest.mark.parametrize("scheme", ["fr", "ftr", "rctree"])
def test_infoflow_matches_reference(scheme):
    """A history of repairs, each planned by both packages: the same
    collector flows and MDS verdicts (rctree breaks MDS)."""
    d, k, n = 4, 2, 6
    rp = ref_core.CodeParams.msr(n=n, k=k, d=d, M=12.0)
    pp = port_core.CodeParams.msr(n=n, k=k, d=d, M=12.0)
    rg = ref_core.InfoFlowGraph(rp, initial_nodes=list(range(1, n + 1)))
    pg = port_core.InfoFlowGraph(pp, initial_nodes=list(range(1, n + 1)))
    newcomer = n + 1
    for r, c in enumerate(_caps(61, 3, d)):
        failed = sorted(rg.live)[r % n]
        providers = [i for i in sorted(rg.live) if i != failed][:d]
        want = ref_core.plan(ref_core.OverlayNetwork(c.tolist()), rp, scheme,
                             engine="scalar")
        got = port_core.plan(port_core.OverlayNetwork(c.tolist()), pp, scheme)
        rg.fail_and_repair(failed, ref_core.event_from_plan(want, newcomer,
                                                            providers))
        pg.fail_and_repair(failed, port_core.event_from_plan(got, newcomer,
                                                             providers))
        newcomer += 1
        assert pg.live == rg.live
        assert pg.worst_collector() == rg.worst_collector()
        assert pg.mds_holds() == rg.mds_holds()
    with pytest.raises(ValueError, match="not live"):
        pg.fail_and_repair(1, port_core.RepairEvent(99, {}, {}))


def test_extensions_match_reference():
    d = 5
    rp = ref_core.CodeParams.msr(n=8, k=3, d=d, M=600.0)
    pp = port_core.CodeParams.msr(n=8, k=3, d=d, M=600.0)
    caps = _caps(71, 3, d)
    for scheme in ("star", "tr", "ftr"):
        for c in caps:
            rn = ref_core.OverlayNetwork(c.tolist())
            pn = port_core.OverlayNetwork(c.tolist())
            want = ref_core.plan(rn, rp, scheme, engine="scalar")
            got = port_core.plan(pn, pp, scheme)
            assert port_core.store_and_forward_time(got, pn) == \
                ref_core.store_and_forward_time(want, rn)
            assert port_core.streaming_time_with_latency(got, pn, 0.1) == \
                ref_core.streaming_time_with_latency(want, rn, 0.1)
    for contention in (0.0, 0.7):
        want = ref_core.plan_multi_failures(
            rp, [ref_core.OverlayNetwork(c.tolist()) for c in caps],
            planner=ref_core.plan_fr, contention=contention)
        got = port_core.plan_multi_failures(
            pp, [port_core.OverlayNetwork(c.tolist()) for c in caps],
            planner=port_core.plan_fr, contention=contention)
        for (gp, gt), (wp, wt) in zip(got, want):
            assert gt == wt
            _same_plan(gp, wp, f"multi-failure, contention {contention}")


def test_theorem6_example_matches_reference():
    rp, rd1, rd2 = ref_core.theorem6_example()
    pp, pd1, pd2 = port_core.theorem6_example()
    assert (pp.n, pp.k, pp.d, pp.M, pp.alpha) == \
        (rp.n, rp.k, rp.d, rp.M, rp.alpha)
    assert (pd1.x, pd2.x) == (rd1.x, rd2.x)
