"""The port's fleet simulator against ``repro.fleet``.

From one seed and the same scenario, built with each package's own
scenario factories (the capacity models are closures, so each side builds
its own from its samplers with the same arguments), the port on
``device="cpu"`` and the reference must give:

* with ``engine="scalar"`` in both packages, summaries that are equal
  (``==``): the scalar planners and the event loop are host copies of the
  reference with the same float arithmetic in the same order;
* at the default engine (the port's planning tier against the reference's
  NumPy batched engine), the golden quick rows: counts equal and every
  float within 1e-9 relative.  The plan-error keys are realized/predicted
  ETA ratios less one, about 1e-16, so they are held to a few roundings
  of the ratio, 16 ulp of 1 + err (ROADMAP C6);
* in an ensemble, the pooled summary, the bootstrap intervals, and each
  member equal to its solo run.
"""
import dataclasses
import json
import math
import pathlib
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.fleet as ref_fleet
import repro.ft as ref_ft
import repro_torch.core as port_core
import repro_torch.fleet as port_fleet
import repro_torch.ft as port_ft
from repro_torch.fleet import policy as port_policy
from repro_torch.kernels import gf_matmul_cuda
from repro_torch.obs import json_sanitize

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "benchmarks" / "golden" / "fleet_quick_seed0.json"
P = dict(n=12, k=3, d=6, M=600.0)
REF_PARAMS = ref_core.CodeParams.msr(**P)
PORT_PARAMS = port_core.CodeParams.msr(**P)

# (factory, kwargs) at n = 16, short enough for about ten failures each
SCENARIOS = {
    "steady": ("steady", dict(duration=400.0)),
    "rack_bursts": ("rack_bursts", dict(duration=300.0)),
    "capacity_weather": ("capacity_weather",
                         dict(duration=300.0, shock_period=60.0)),
    "flaky_providers": ("flaky_providers", dict(duration=200.0)),
    "stragglers": ("stragglers", dict(duration=250.0)),
    "foggy_estimates": ("foggy_estimates", dict(duration=400.0)),
    "mitigated": ("stragglers", dict(duration=250.0)),
    "tiered": ("tiered", dict(duration=300.0)),
    "hot_reads": ("hot_reads", dict(duration=400.0)),
}


def _scenario(pkg, kind, n=16, **over):
    factory, kw = SCENARIOS[kind]
    sc = pkg.SCENARIOS[factory](n, **kw)
    if kind == "mitigated":
        sc = pkg.mitigated(sc)
    return dataclasses.replace(sc, **over) if over else sc


def _both(kind, policy, engine, seed, **over):
    ref = ref_fleet.simulate(_scenario(ref_fleet, kind, **over),
                             ref_fleet.make_policy(policy, engine=engine),
                             REF_PARAMS, seed=seed)
    port = port_fleet.simulate(_scenario(port_fleet, kind, **over),
                               port_fleet.make_policy(policy, engine=engine),
                               PORT_PARAMS, seed=seed, device="cpu")
    return port, ref


# a plan-error key is a ratio less one: 16 roundings of the ratio
PLAN_ERR_TOL = 16 * np.finfo(np.float64).eps


def assert_summary_close(got, expect, name=""):
    """Counts equal, floats within 1e-9 relative; a plan-error key within
    PLAN_ERR_TOL of the ratio it is defined from."""
    assert set(got) == set(expect), name
    for key, e in expect.items():
        g = got[key]
        msg = f"{name}.{key}: port {g!r} reference {e!r}"
        if e is None or isinstance(e, int) or g is None:
            assert g == e and type(g) is type(e), msg
            continue
        if math.isinf(e):
            assert g == e, msg
        elif key.startswith("plan_err"):
            assert abs(g - e) <= PLAN_ERR_TOL * abs(1.0 + e), msg
        else:
            assert abs(g - e) <= 1e-9 * abs(e), msg


@pytest.mark.parametrize("kind", list(SCENARIOS))
def test_scalar_engine_summary_bitwise(kind):
    port, ref = _both(kind, "flexible", "scalar", seed=11)
    assert ref["completed"] > 0
    assert port == ref


def test_lifecycle_and_robustness_knobs_bitwise():
    """Carryover, migration, bank-aware migration, the watchdog and
    degraded-d admission, all on, under brownouts and provider loss."""
    over = dict(carryover=True, migration=True, bank_aware_migration=True,
                watchdog_period=20.0, degraded_d=True, degrade_rate=2e-3,
                degrade_mean_duration=80.0, degrade_hi=0.1)
    port, ref = _both("flaky_providers", "flexible", "scalar", seed=5,
                      duration=120.0, **over)
    assert ref["migrations"] + ref["watchdog_flags"] > 0
    assert ref["carryover_aborts"] > 0
    assert port == ref


def _golden_rows(pkg):
    rows = {}
    n, lam = 16, 2e-3
    for pol in ("star", "ftr", "flexible"):
        rows[f"n{n}_lam{lam:g}_{pol}"] = (pkg.SCENARIOS["steady"](
            n, failure_rate=lam, duration=40 / (lam * n)), pol)
    lam = 4e-3
    rows[f"flaky_providers_n{n}_flexible"] = (
        pkg.SCENARIOS["flaky_providers"](n, failure_rate=lam,
                                         duration=40 / (lam * n)),
        "flexible")
    return rows


def _config_seed(root_seed, name):
    return (root_seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 31)


GOLDEN_ROWS = sorted(json.loads(GOLDEN.read_text())["configs"])


@pytest.mark.parametrize("name", GOLDEN_ROWS)
def test_golden_quick_rows_default_engine(name):
    """The golden's rows, re-simulated by the port at the default engine
    (planning through the tier, here on CPU tensors)."""
    golden = json.loads(GOLDEN.read_text())
    sc, pol = _golden_rows(port_fleet)[name]
    got = json_sanitize(port_fleet.simulate(
        sc, port_fleet.make_policy(pol), PORT_PARAMS,
        seed=_config_seed(golden["root_seed"], name), device="cpu"))
    assert_summary_close(got, golden["configs"][name], name)
    assert gf_matmul_cuda.launches == 0


def test_check_shares_oracle_runs_clean():
    """The full-rescan oracle shadows every incremental recompute."""
    sc = _scenario(port_fleet, "flaky_providers", carryover=True,
                   migration=True, read_rate=0.05, shock_period=40.0,
                   shock_lo=0.3)
    checked = port_fleet.FleetSimulator(
        sc, port_fleet.make_policy("tr", engine="scalar"), PORT_PARAMS,
        seed=2, check_shares=True, device="cpu").run().summary()
    plain = port_fleet.simulate(sc, port_fleet.make_policy(
        "tr", engine="scalar"), PORT_PARAMS, seed=2, device="cpu")
    assert plain["completed"] > 0 and plain["migrations"] > 0
    assert checked == plain


def test_ensemble_matches_reference_and_solo_runs():
    kw = dict(num_nodes=24, duration=80.0, failure_rate=4e-3,
              max_concurrent=8)
    ref_sc = ref_fleet.Scenario(
        capacity_model=ref_fleet.scenario.uniform_matrix(0.3, 8.0), **kw)
    port_sc = port_fleet.Scenario(
        capacity_model=port_fleet.scenario.uniform_matrix(0.3, 8.0), **kw)
    ref = ref_fleet.ClusterEnsemble(
        ref_sc, lambda: ref_fleet.make_policy("star", engine="scalar"),
        REF_PARAMS, clusters=3, root_seed=4)
    port = port_fleet.ClusterEnsemble(
        port_sc, lambda: port_fleet.make_policy("star", engine="scalar"),
        PORT_PARAMS, clusters=3, root_seed=4, device="cpu")
    ref_members, port_members = ref.run(), port.run()
    assert port.pooled().summary() == ref.pooled().summary()
    assert port.pooled().summary()["completed"] > 0
    keys = ("mean_backlog", "regen_p50", "regen_p99", "unavail_fraction",
            "mttdl_estimate")
    assert port.cis(keys, n_boot=50, seed=3) == ref.cis(keys, n_boot=50,
                                                         seed=3)
    for seed, member, ref_member in zip(port.seeds, port_members,
                                        ref_members):
        solo = port_fleet.simulate(port_sc, port_fleet.make_policy(
            "star", engine="scalar"), PORT_PARAMS, seed=seed, device="cpu")
        assert member.summary() == solo == ref_member.summary()
    assert port_fleet.bootstrap_cis(port_members, keys, n_boot=20) == \
        ref_fleet.bootstrap_cis(ref_members, keys, n_boot=20)
    assert port_fleet.cluster_seed(7, 3) == ref_fleet.cluster_seed(7, 3)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_or_cpu_by_name(no_cuda):
    sc = _scenario(port_fleet, "steady")
    pol = port_fleet.make_policy("star")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fleet.FleetSimulator(sc, pol, PORT_PARAMS)
    with pytest.raises(RuntimeError):
        port_fleet.simulate(sc, pol, PORT_PARAMS)
    with pytest.raises(RuntimeError):
        port_fleet.ClusterEnsemble(sc, lambda: pol, PORT_PARAMS, clusters=2)
    # a policy called without a device plans on the card, so it raises too
    caps = np.full((1, 7, 7), 10.0)
    with pytest.raises(RuntimeError):
        pol.plan_batch(caps, PORT_PARAMS)
    sim = port_fleet.FleetSimulator(sc, pol, PORT_PARAMS, device="cpu")
    assert sim.device.type == "cpu"


def test_engine_jax_raises_naming_batched():
    for make in (lambda: port_fleet.make_policy("ftr", engine="jax"),
                 lambda: port_fleet.FlexiblePolicy(engine="jax")):
        with pytest.raises(ValueError, match="batched"):
            make()
    with pytest.raises(ValueError, match="unknown engine"):
        port_fleet.make_policy("star", engine="fast")
    with pytest.raises(ValueError, match="unknown scheme"):
        port_fleet.make_policy("nope")
    # rctree has no batched planner: "batched" is resolved to the scalar
    # planner without the registry's warning
    assert port_policy._engine_for("rctree", "batched") == "scalar"
    assert port_policy._engine_for("ftr", "batched") == "batched"


def _overlays(seed, R, d=6):
    rng = np.random.default_rng(seed)
    caps = rng.uniform(1.0, 30.0, size=(R, d + 1, d + 1))
    for c in caps:
        np.fill_diagonal(c, 0.0)
    return caps


@pytest.mark.parametrize("engine", ["scalar", "auto"])
@pytest.mark.parametrize("spec", ["star", "ftr", "rctree", "flexible"])
def test_policy_plans_match_reference(spec, engine):
    caps = _overlays(3, 5)
    ref = ref_fleet.make_policy(spec, engine=engine).plan_batch(
        caps, REF_PARAMS)
    port = port_fleet.make_policy(spec, engine=engine).plan_batch(
        caps, PORT_PARAMS, device="cpu")
    for p, r in zip(port, ref):
        assert p.scheme == r.scheme and p.parent == r.parent
        if engine == "scalar" or spec == "rctree":
            assert (p.time, p.betas, p.flows) == (r.time, r.betas, r.flows)
        else:
            np.testing.assert_allclose(p.betas, r.betas, rtol=1e-9)
            assert p.time == pytest.approx(r.time, rel=1e-9)


def test_flexible_first_minimum_wins_ties(monkeypatch):
    """Schemes that tie on a lane: the first in order wins, as in the
    reference."""
    caps = _overlays(8, 4)
    calls = []
    real = port_policy._plan_schemes

    def spy(*args):
        out = real(*args)
        calls.append(out)
        return out

    monkeypatch.setattr(port_policy, "_plan_schemes", spy)
    pol = port_fleet.FlexiblePolicy(schemes=("tr", "star", "tr"),
                                    engine="scalar")
    plans = pol.plan_batch(caps, PORT_PARAMS, device="cpu")
    [per_scheme] = calls
    ref = ref_fleet.FlexiblePolicy(schemes=("tr", "star", "tr"),
                                   engine="scalar").plan_batch(caps,
                                                               REF_PARAMS)
    for r, (plan, ref_plan) in enumerate(zip(plans, ref)):
        times = [p[r].time for p in per_scheme]
        assert times[0] == times[2]
        assert plan is per_scheme[times.index(min(times))][r]
        assert (plan.scheme, plan.time) == (ref_plan.scheme, ref_plan.time)
    slate = pol.replan_candidates(caps, PORT_PARAMS, device="cpu")
    assert [[c.scheme for c in cands] for cands in slate] == \
        [["tr", "star", "tr"]] * 4


def test_plans_from_batches_equals_one_batch_at_a_time():
    caps = torch.from_numpy(_overlays(5, 6))
    results = [port_core.plan_many(caps, PORT_PARAMS, s, device="cpu")
               for s in ("ftr", "star", "rctree", "fr")]
    many = port_core.plans_from_batches(results, PORT_PARAMS)
    for res, plans in zip(results, many):
        one = port_core.plans_from_batch(res, PORT_PARAMS)
        assert [(p.parent, p.betas, p.flows, p.time, p.lower_bound)
                for p in plans] == \
            [(p.parent, p.betas, p.flows, p.time, p.lower_bound)
             for p in one]


def test_tiered_topology_matches_reference():
    cfg = dict(num_pods=3, hosts_per_pod=5, straggler_fraction=0.3)
    ref = ref_ft.Fleet(ref_ft.FleetConfig(**cfg), seed=9)
    port = port_ft.Fleet(port_ft.FleetConfig(**cfg), seed=9)
    assert port.straggle == ref.straggle
    hosts = list(range(15))
    assert port.capacity_matrix(hosts, 64.0, np.random.default_rng(1)) == \
        ref.capacity_matrix(hosts, 64.0, np.random.default_rng(1))
    import random
    assert port.snapshot_overlay(0, [3, 7, 11], rng=random.Random(2)).cap == \
        ref.snapshot_overlay(0, [3, 7, 11], rng=random.Random(2)).cap
    r = port_fleet.tiered_capacities()(np.random.default_rng(6), 12)
    np.testing.assert_array_equal(
        r, ref_fleet.tiered_capacities()(np.random.default_rng(6), 12))


@pytest.mark.parametrize("bad", [
    dict(num_nodes=1), dict(duration=0.0), dict(max_concurrent=0),
    dict(rack_burst_prob=1.5), dict(estimate_noise=1.0),
    dict(degrade_rate=1.0), dict(degrade_hi=1.0, degrade_lo=0.5),
    dict(watchdog_lag=0.5), dict(watchdog_backoff=0.5),
    dict(trace_capacity=0), dict(dataplane=True, read_fanin=40),
    dict(dataplane=True, dataplane_matmul="fast"),
    dict(read_trace=port_fleet.ReadTrace(rate=1.0)),
])
def test_scenario_validation_matches_reference(bad):
    base = dict(num_nodes=16, duration=100.0)
    ref_bad = dict(bad)
    if "read_trace" in ref_bad:
        ref_bad["read_trace"] = ref_fleet.ReadTrace(rate=1.0)
    with pytest.raises(ValueError) as ref_err:
        ref_fleet.Scenario(**{**base, **ref_bad})
    with pytest.raises(ValueError) as port_err:
        port_fleet.Scenario(**{**base, **bad})
    assert str(port_err.value) == str(ref_err.value)


def test_package_surface_matches_reference():
    import repro.obs as ref_obs
    import repro_torch.obs as port_obs
    assert sorted(port_fleet.__all__) == sorted(ref_fleet.__all__)
    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)
    assert port_fleet.metrics.COUNTER_SUMMARY_KEYS == \
        ref_fleet.metrics.COUNTER_SUMMARY_KEYS
    assert sorted(port_fleet.SCENARIOS) == sorted(ref_fleet.SCENARIOS)
    assert port_fleet.sim._STREAMS == ref_fleet.sim._STREAMS
