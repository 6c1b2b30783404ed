"""The planner profile's stages in the port's device tier
(``repro_torch.core.torch_engine``) against the reference's batched engine,
on the CPU.

The stage names a profiled ``plan_many`` records equal the reference's
(``repro.core.plan_many(engine="batched")``) for star, fr, tr and ftr, at
MSR and at an interior point, with and without a zero link (the closed
form's lanes); so do the counters.  A profiled plan is bitwise the
unprofiled one (stages only measure), and ``torch_engine.syncs`` moves the
same with and without a profile.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
from repro.obs.profile import PlannerProfile as RefProfile
import repro_torch.core as port_core
from repro_torch.core import torch_engine as te
from repro_torch.obs.profile import PlannerProfile
from test_torch_engine import _caps, _params

SCHEMES = ("star", "fr", "tr", "ftr")
CASES = [(6, 3, False, False), (6, 3, True, False), (6, 3, False, True)]
CASE_IDS = ["msr", "interior", "msr-zero-link"]


def _batch(d, k, interior, zero_link):
    caps = _caps(11, 8, d)
    if zero_link:
        caps[::2, 1, 0] = 0.0       # some lanes leave the closed form
    return caps


@pytest.mark.parametrize("d,k,interior,zero_link", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_stage_names_and_counters_match_reference(scheme, d, k, interior,
                                                   zero_link):
    caps = _batch(d, k, interior, zero_link)
    rprof, pprof = RefProfile(), PlannerProfile()
    ref_core.plan_many(caps, _params(ref_core, d, k, interior), scheme,
                       engine="batched", profile=rprof)
    port_core.plan_many(caps, _params(port_core, d, k, interior), scheme,
                        engine="batched", profile=pprof, device="cpu")
    rs, ps = rprof.summary(), pprof.summary()
    assert list(ps["stages"]) == list(rs["stages"])
    assert {n: s["calls"] for n, s in ps["stages"].items()} == \
        {n: s["calls"] for n, s in rs["stages"].items()}
    assert ps["counters"] == rs["counters"]


@pytest.mark.parametrize("d,k,interior,zero_link", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_profiled_plan_is_bitwise_the_plain_plan(scheme, d, k, interior,
                                                 zero_link):
    caps = _batch(d, k, interior, zero_link)
    params = _params(port_core, d, k, interior)
    before = te.syncs
    plain = port_core.plan_many(caps, params, scheme, device="cpu")
    plain_syncs = te.syncs - before
    before = te.syncs
    prof = PlannerProfile()
    got = port_core.plan_many(caps, params, scheme, device="cpu",
                              profile=prof)
    assert te.syncs - before == plain_syncs
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert "total" in prof.summary()["stages"]


def test_plan_passes_the_profile_to_the_batched_planner():
    d, k = 6, 3
    caps = _caps(3, 1, d)
    net = port_core.OverlayNetwork(caps[0].tolist())
    rnet = ref_core.OverlayNetwork(caps[0].tolist())
    rprof, pprof = RefProfile(), PlannerProfile()
    want = ref_core.plan(rnet, _params(ref_core, d, k, False), "ftr",
                         engine="batched", profile=rprof)
    got = port_core.plan(net, _params(port_core, d, k, False), "ftr",
                         engine="batched", profile=pprof, device="cpu")
    assert list(pprof.summary()["stages"]) == list(rprof.summary()["stages"])
    assert got.parent == want.parent
    np.testing.assert_allclose(got.time, want.time, rtol=1e-9)


def test_quickstart_matches_the_reference_script(capsys):
    """``python -m repro_torch.quickstart --device cpu`` prints what
    ``examples/quickstart.py`` prints; its plan times are the reference
    planners' within 1e-9 relative and its parents theirs exactly, and so
    are the batch's mean times."""
    import pathlib
    import subprocess
    import sys
    from repro_torch import quickstart
    root = pathlib.Path(__file__).resolve().parents[1]
    ref = subprocess.run(
        [sys.executable, str(root / "examples" / "quickstart.py")],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={"PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert ref.returncode == 0, ref.stderr
    out = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out == ref.stdout
    P = ref_core.CodeParams.msr(n=5, k=2, d=4, M=480.0)
    net = ref_core.OverlayNetwork.star_only([70.0, 50.0, 20.0, 10.0],
                                            cross=5.0)
    net.cap[4][1] = 35.0
    for scheme, got in out["plans"].items():
        want = ref_core.plan(net, P, scheme)
        assert got.parent == want.parent, scheme
        np.testing.assert_allclose(got.time, want.time, rtol=1e-9)
        np.testing.assert_allclose(got.total_traffic, want.total_traffic,
                                   rtol=1e-9)
    assert out["file_restored"]
    import random
    rng = random.Random(0)
    caps = ref_core.caps_tensor([ref_core.OverlayNetwork(
        [[0.0 if u == v else rng.uniform(10.0, 120.0) for v in range(5)]
         for u in range(5)]) for _ in range(16)])
    assert set(out["batch_means"]) == set(quickstart.BATCHED_FAMILY)
    for scheme, got in out["batch_means"].items():
        want = ref_core.plan_many(caps, P, scheme, engine="batched")
        np.testing.assert_allclose(got, want.times.mean(), rtol=1e-9)


def test_quickstart_runs_on_the_card_unless_told(monkeypatch):
    from repro_torch import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
