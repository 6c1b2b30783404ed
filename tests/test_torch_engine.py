"""The port's device planning tier (``repro_torch.core.torch_engine``) and the
batch API of ``plan_many``, on the CPU, against ``repro.core``.

The cross-engine contract of the reference (``src/README.md``, engine
matrix; ``tests/test_jax_engine.py``): tree ``parents`` are equal, star
times are bitwise, and times, traffic, betas and lower bounds agree within
1e-9 relative.  The tier is held against the reference's NumPy batched
engine (``repro.core.plan_many(engine="batched")``) and the scalar planners.
Small sizes: d in {4, 6}, B <= 16.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.core.batched as ref_batched
import repro_torch.core as port_core
from repro_torch.core import api as port_api
from repro_torch.core import torch_engine as te

REL_TOL = 1e-9
SCHEMES = ("star", "fr", "tr", "ftr", "shah")
FIELDS = ("times", "traffic", "betas", "lower_bounds")


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


def _same_batch(got, want, msg):
    """``got`` (the port's tensors) against ``want`` (the reference's
    arrays) under the contract."""
    np.testing.assert_array_equal(got.parents.numpy(), want.parents,
                                  err_msg=f"{msg}: parents")
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f"{msg}: {f}"
        if w is not None:
            _close(g.numpy(), w, f"{msg}: {f}")


CASES = [(4, 2, False), (4, 2, True), (6, 3, False), (6, 3, True)]
CASE_IDS = [f"d{d}k{k}-{'interior' if i else 'msr'}" for d, k, i in CASES]


@pytest.mark.parametrize("d,k,interior", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_matches_reference_and_scalar(scheme, d, k, interior):
    rp = _params(ref_core, d, k, interior)
    pp = _params(port_core, d, k, interior)
    caps = _caps(7 + d + interior, 9, d)
    got = port_core.plan_many(caps, pp, scheme, device="cpu")
    want = ref_core.plan_many(caps, rp, scheme, engine="batched")
    assert got.engine == want.engine == "batched"
    assert got.plans is None
    _same_batch(got, want, scheme)
    if scheme == "star":
        np.testing.assert_array_equal(got.times.numpy(), want.times)
    for b, c in enumerate(caps):
        ps = port_core.plan(port_core.OverlayNetwork(c.tolist()), pp, scheme,
                            engine="scalar")
        assert {u: int(got.parents[b, u]) for u in range(1, d + 1)} \
            == ps.parent, f"{scheme} row {b}"
        _close(got.times[b], ps.time, f"{scheme} row {b}: time")
        _close(got.betas[b].numpy(), ps.betas, f"{scheme} row {b}: betas")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_result_dtypes_and_device(scheme):
    pp = _params(port_core, 4, 2, True)
    res = port_core.plan_many(_caps(2, 3, 4), pp, scheme, device="cpu")
    for f in FIELDS:
        t = getattr(res, f)
        if t is not None:
            assert t.dtype == torch.float64 and t.device.type == "cpu", f
    assert res.parents.dtype == torch.int64
    assert res.times.shape == res.traffic.shape == (3,)
    assert res.betas.shape == (3, 4) and res.parents.shape == (3, 5)
    assert (res.lower_bounds is not None) == (scheme in ("fr", "ftr"))
    caps = port_core.caps_tensor(
        [port_core.OverlayNetwork(c.tolist()) for c in _caps(2, 3, 4)],
        device="cpu")
    assert caps.dtype == torch.float64 and caps.shape == (3, 5, 5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_lanes_are_independent(scheme):
    """A batch of 7 (not a power of two) equals its lanes planned alone."""
    pp = _params(port_core, 6, 3, False)
    caps = _caps(31, 7, 6)
    whole = port_core.plan_many(caps, pp, scheme, device="cpu")
    for b in range(7):
        one = port_core.plan_many(caps[b:b + 1], pp, scheme, device="cpu")
        assert torch.equal(one.parents[0], whole.parents[b]), (scheme, b)
        for f in FIELDS:
            g = getattr(whole, f)
            if g is not None:
                _close(getattr(one, f)[0].numpy(), g[b].numpy(),
                       f"{scheme} lane {b}: {f}")


@pytest.mark.parametrize("interior", [False, True], ids=["msr", "interior"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_infeasible_lanes_like_reference(scheme, interior):
    """A dead direct link, a provider that can send nowhere, and a lane
    of all zeros give the reference's inf times and zeros."""
    rp = _params(ref_core, 4, 2, interior)
    pp = _params(port_core, 4, 2, interior)
    caps = _caps(41, 5, 4)
    caps[1, 2, 0] = 0.0
    caps[2, 3, :] = 0.0
    caps[3] = 0.0
    got = port_core.plan_many(caps, pp, scheme, device="cpu")
    want = ref_core.plan_many(caps, rp, scheme, engine="batched")
    _same_batch(got, want, scheme)
    assert np.isinf(got.times.numpy()[3])


def test_speculative_bisection_is_plain_bisection(monkeypatch):
    """Evaluating 2^L - 1 midpoints per oracle call walks the same path as
    one midpoint per call: the plans are bitwise equal."""
    pp = _params(port_core, 6, 3, True)
    caps = torch.from_numpy(_caps(3, 5, 6))
    spec = {s: getattr(te, f"plan_{s}_batch")(caps, pp)
            for s in ("fr", "ftr", "shah")}
    monkeypatch.setattr(te, "_SPEC_LEVELS", 1)
    for s, want in spec.items():
        got = getattr(te, f"plan_{s}_batch")(caps, pp)
        assert torch.equal(got.parents, want.parents), s
        for f in FIELDS:
            if getattr(want, f) is not None:
                assert torch.equal(getattr(got, f), getattr(want, f)), (s, f)


@pytest.mark.parametrize("seed,d,P", [(5, 6, 64), (7, 4, 16), (11, 10, 48)])
def test_fixed_round_waterfill_matches_reference(seed, d, P):
    """The water-fill (at most d rounds, an exit read after each) against
    the reference's ``waterfill_batch`` on the subtree families of random
    trees, and the subtree masks against the reference's."""
    rng = np.random.default_rng(seed)
    parents = np.zeros((P, d + 1), dtype=np.int64)
    for u in range(1, d + 1):
        parents[:, u] = rng.integers(0, u, size=P)     # parents precede u
    mask = ref_batched.subtree_masks(parents)
    inc = np.ascontiguousarray(mask[:, 1:, :])
    alpha = 100.0
    bnd = rng.uniform(5.0, 2.5 * alpha, size=(P, d))
    bnd[rng.random((P, d)) < 0.3] = np.inf
    want = ref_batched.waterfill_batch(inc, bnd, alpha)
    t_inc = torch.from_numpy(inc)
    got = te._waterfill(t_inc, torch.from_numpy(bnd), alpha, te._nest(t_inc))
    _close(got.numpy(), want, "water-fill")
    np.testing.assert_array_equal(
        te._subtree_masks(torch.from_numpy(parents)).numpy(), mask)


def test_engine_counts_its_device_reads():
    pp = _params(port_core, 4, 2, True)
    caps = torch.from_numpy(_caps(8, 4, 4))
    before = te.syncs
    te.plan_star_batch(caps, pp)
    te.plan_tr_batch(caps, pp)
    assert te.syncs == before            # no data-dependent loop
    te.plan_ftr_batch(caps, pp)
    assert te.syncs > before


def test_ragged_rows_in_input_order():
    """Mixed fan-outs 6, 4, 6, 5, 4: each row equals that overlay planned
    alone with params re-targeted to its d, zero padding beyond it."""
    params = _params(port_core, 6, 3, False)
    ds = [6, 4, 6, 5, 4]
    nets = [port_core.OverlayNetwork(_caps(11 + i, 1, d)[0].tolist())
            for i, d in enumerate(ds)]
    for s in ("fr", "ftr"):
        res = port_core.plan_many(nets, params, s, device="cpu")
        assert res.engine == "batched"
        assert res.betas.shape == (5, 6) and res.parents.shape == (5, 7)
        for i, (net, d) in enumerate(zip(nets, ds)):
            ps = port_core.plan(net, dataclasses.replace(params, d=d), s,
                                engine="scalar")
            _close(res.times[i], ps.time, f"{s} row {i}")
            _close(res.betas[i, :d].numpy(), ps.betas, f"{s} row {i}")
            assert {u: int(res.parents[i, u])
                    for u in range(1, d + 1)} == ps.parent, (s, i)
            assert (res.betas[i, d:] == 0).all()
            assert (res.parents[i, d + 1:] == 0).all()
            assert res.plans[i].params.d == d
            res.plans[i].validate(net)
    with pytest.raises(ValueError, match="k <= d"):
        port_core.plan_many(
            [nets[0], port_core.OverlayNetwork(_caps(20, 1, 2)[0].tolist())],
            params, "fr", device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_single_network_roundtrip(scheme):
    """plan(engine='batched') plans a batch of one and materializes a plan
    that validates against the overlay."""
    pp = _params(port_core, 4, 2, True)
    net = port_core.OverlayNetwork(_caps(3, 1, 4)[0].tolist())
    pb = port_core.plan(net, pp, scheme, engine="batched", device="cpu")
    po = port_core.plan(net, pp, scheme, engine="scalar")
    assert pb.parent == po.parent
    assert pb.scheme == scheme
    _close(pb.time, po.time, scheme)
    _close(pb.total_traffic, po.total_traffic, scheme)
    pb.validate(net)


def test_engine_contract_errors():
    """The batched engine refuses the LP witness (the scalar engine takes
    it) and the reference's "jax" engine by name; unknown engines, schemes
    and witnesses raise."""
    pp = _params(port_core, 4, 2, True)
    caps = _caps(4, 2, 4)
    net = port_core.OverlayNetwork(caps[0].tolist())
    for s in ("fr", "ftr"):
        with pytest.raises(ValueError, match="witness"):
            port_core.plan_many(caps, pp, s, witness="lp", device="cpu")
        with pytest.raises(ValueError, match="witness"):
            port_core.plan(net, pp, s, engine="batched", witness="lp",
                           device="cpu")
        assert port_core.plan_many(caps, pp, s, engine="scalar",
                                   witness="lp").engine == "scalar"
    with pytest.raises(ValueError, match="'batched'"):
        port_core.plan_many(caps, pp, "fr", engine="jax", device="cpu")
    with pytest.raises(ValueError, match="'batched'"):
        port_core.plan(net, pp, "fr", engine="jax")
    with pytest.raises(ValueError, match="unknown engine"):
        port_core.plan_many(caps, pp, "fr", engine="warp")
    with pytest.raises(ValueError, match="unknown scheme"):
        port_core.plan_many(caps, pp, "nope")
    with pytest.raises(ValueError, match="witness"):
        port_core.plan(net, pp, "fr", witness="greedy")


def test_rctree_warns_once_and_comes_back_verbatim():
    pp = _params(port_core, 4, 2, False)
    caps = _caps(6, 3, 4)
    nets = [port_core.OverlayNetwork(c.tolist()) for c in caps]
    port_api._warned_scalar_fallback.discard("rctree")
    with pytest.warns(RuntimeWarning, match="no batched planner"):
        res = port_core.plan_many(caps, pp, "rctree", engine="batched")
    assert res.engine == "scalar" and res.times.device.type == "cpu"
    want = [port_core.plan(n, pp, "rctree") for n in nets]
    assert port_core.plans_from_batch(res, pp) == res.plans == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # the second call is silent
        port_core.plan_many(caps, pp, "rctree", engine="batched")
        assert port_core.plan_many(nets, pp, "rctree").engine == "scalar"


def test_plan_many_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = _params(port_core, 4, 2, False)
    caps = _caps(9, 2, 4)
    nets = [port_core.OverlayNetwork(c.tolist()) for c in caps]
    for batch in (caps, nets, torch.from_numpy(caps)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_core.plan_many(batch, pp, "ftr")
    with pytest.raises(RuntimeError):
        port_core.plan(nets[0], pp, "fr", engine="batched")
    with pytest.raises(RuntimeError):
        port_core.caps_tensor(nets)
    assert port_core.plan_many(nets, pp, "ftr",
                               device="cpu").times.device.type == "cpu"
    assert port_core.plan_many(caps, pp, "ftr", engine="scalar").engine \
        == "scalar"


def test_profile_hook_notes_and_times():
    """The duck-typed ``profile=`` contract (``note``, ``stage``,
    ``count``): fr at MSR with every direct link positive times its
    closed form inside the total, as the reference's batched engine does
    (``test_torch_profile.py`` holds every scheme's stages to it)."""
    class Profile:
        def __init__(self):
            self.notes, self.stages, self.counts = [], [], {}

        def note(self, **kw):
            self.notes.append(kw)

        def stage(self, name):
            self.stages.append(name)
            return warnings.catch_warnings()     # any context manager

        def count(self, name, n):
            self.counts[name] = self.counts.get(name, 0) + n

    prof = Profile()
    pp = _params(port_core, 4, 2, False)
    port_core.plan_many(_caps(1, 3, 4), pp, "fr", profile=prof, device="cpu")
    assert prof.notes == [dict(scheme="fr", batch=3, d=4, engine="batched",
                               fallback=False)]
    assert prof.stages == ["total", "closed_form"]
    assert prof.counts == dict(lanes=3, closed_form_lanes=3,
                               bisection_lanes=0)


def test_batch_witnesses_match_reference():
    rp = _params(ref_core, 6, 3, True)
    pp = _params(port_core, 6, 3, True)
    caps = _caps(13, 6, 6)
    rr = ref_core.plan_many(caps, rp, "ftr", engine="batched")
    region = ref_core.heuristic_region(rp)
    pregion = port_core.heuristic_region(pp)
    lanes = np.array([True, True, False, True, True, True])
    t = rr.lower_bounds.copy()
    t[4] = np.inf
    _close(port_core.tree_traffic_batch(t, rr.parents, caps, pregion,
                                        pp.alpha, lanes=lanes),
           ref_core.tree_traffic_batch(t, rr.parents, caps, region, rp.alpha,
                                       lanes=lanes), "tree witness")
    fr = ref_core.plan_many(caps, rp, "fr", engine="batched")
    direct = caps[:, 1:, 0]
    _close(port_core.min_traffic_batch(fr.lower_bounds, direct, pregion,
                                       pp.alpha, lanes=lanes),
           ref_core.min_traffic_batch(fr.lower_bounds, direct, region,
                                      rp.alpha, lanes=lanes), "star witness")
