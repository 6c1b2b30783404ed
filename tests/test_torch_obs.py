"""The port's flight recorder, link tracer, report and planner profile
against ``repro.obs``.

* Tracing is observation: inside the port a traced run's summary equals
  the untraced run's, bitwise, with and without the data plane.
* On a scalar-engine run the port's JSONL equals the reference's line for
  line, and so do the Chrome trace objects; the schema and kind strings
  are the reference's, so each package's ``report`` renders the other's
  trace to the same text.
* The ``profile=`` hook of the port's ``plan``/``plan_many`` works with
  the port's ``PlannerProfile``: the ``"total"`` stage and the notes.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import repro.fleet as ref_fleet
import repro.obs as ref_obs
import repro.obs.report as ref_report
import repro_torch.core as port_core
import repro_torch.fleet as port_fleet
import repro_torch.obs as port_obs
import repro_torch.obs.report as port_report

P = dict(n=12, k=3, d=6, M=600.0)
REF_PARAMS = ref_core.CodeParams.msr(**P)
PORT_PARAMS = port_core.CodeParams.msr(**P)


def _port_scenario(kind, **over):
    sc = {
        "flaky": lambda: port_fleet.flaky_providers(16, duration=200.0),
        "stragglers": lambda: port_fleet.mitigated(
            port_fleet.stragglers(16, duration=250.0)),
        "dataplane": lambda: dataclasses.replace(
            port_fleet.hot_reads(16, duration=300.0, dataplane=True,
                                 dataplane_verify=True),
            shock_period=40.0, shock_lo=0.35),
    }[kind]()
    return dataclasses.replace(sc, **over)


@pytest.mark.parametrize("engine", ["scalar", "auto"])
@pytest.mark.parametrize("kind", ["flaky", "stragglers", "dataplane"])
def test_traced_equals_untraced(kind, engine):
    pol = "flexible" if engine == "scalar" else "ftr"
    runs = []
    for trace in (False, True):
        sim = port_fleet.FleetSimulator(
            _port_scenario(kind, trace=trace, carryover=True,
                           migration=True),
            port_fleet.make_policy(pol, engine=engine), PORT_PARAMS,
            seed=5, device="cpu")
        runs.append((sim, sim.run().summary()))
    (plain, untraced), (traced_sim, traced) = runs
    assert plain.recorder is None and plain.link_tracer is None
    assert len(traced_sim.recorder) > 0
    assert traced == untraced
    if kind == "dataplane":
        for a, b in zip(plain.dataplane.store.nodes.values(),
                        traced_sim.dataplane.store.nodes.values()):
            assert torch.equal(a.payload, b.payload)


def _traced_pair(seed=3):
    kw = dict(carryover=True, migration=True, trace=True)
    ref_sc = dataclasses.replace(ref_fleet.flaky_providers(16,
                                                           duration=200.0),
                                 **kw)
    port_sc = _port_scenario("flaky", **kw)
    ref = ref_fleet.FleetSimulator(
        ref_sc, ref_fleet.make_policy("flexible", engine="scalar"),
        REF_PARAMS, seed=seed)
    port = port_fleet.FleetSimulator(
        port_sc, port_fleet.make_policy("flexible", engine="scalar"),
        PORT_PARAMS, seed=seed, device="cpu")
    ref.run()
    port.run()
    return port, ref


@pytest.fixture(scope="module")
def dataplane_pair():
    """One traced data-plane run per package, finished."""
    def sc(pkg):
        return dataclasses.replace(
            pkg.hot_reads(16, duration=300.0, dataplane=True,
                          dataplane_verify=True),
            shock_period=40.0, shock_lo=0.35, trace=True)
    ref = ref_fleet.FleetSimulator(
        sc(ref_fleet), ref_fleet.make_policy("ftr", engine="scalar"),
        REF_PARAMS, seed=5)
    port = port_fleet.FleetSimulator(
        sc(port_fleet), port_fleet.make_policy("ftr", engine="scalar"),
        PORT_PARAMS, seed=5, device="cpu")
    for sim in (port, ref):
        sim.run()
    return port, ref


@pytest.mark.parametrize("which", ["lifecycle", "dataplane"])
def test_jsonl_and_chrome_equal_the_reference(which, dataplane_pair):
    if which == "lifecycle":
        port, ref = _traced_pair()
        for sim in (port, ref):
            sim.finish()
    else:
        port, ref = dataplane_pair
    port_lines = port.recorder.to_jsonl().splitlines()
    ref_lines = ref.recorder.to_jsonl().splitlines()
    assert len(port_lines) == len(ref_lines) > 10
    for i, (a, b) in enumerate(zip(port_lines, ref_lines)):
        assert a == b, f"line {i}"
    assert port.recorder.to_chrome() == ref.recorder.to_chrome()
    events = port.recorder.events
    assert port_obs.chrome_trace(events) == ref_obs.chrome_trace(events)
    chrome = port.recorder.to_chrome()
    assert port_obs.finished_transfer_spans(chrome) == \
        ref_obs.finished_transfer_spans(chrome)


def test_reports_render_each_others_traces(dataplane_pair, tmp_path):
    port, ref = dataplane_pair
    paths = {}
    for tag, sim in (("port", port), ("ref", ref)):
        paths[tag] = str(tmp_path / f"{tag}.jsonl")
        sim.recorder.save_jsonl(paths[tag])
    texts = set()
    for path in paths.values():
        for report in (port_report, ref_report):
            header, events = report.load_jsonl(path)
            texts.add(report.render_report(header, events, 5))
    assert len(texts) == 1
    assert "bytes" in texts.pop()
    header, events = port_report.load_jsonl(paths["ref"])
    assert port_report.top_links_by_bytes(header, events, 5) == \
        ref_report.top_links_by_bytes(header, events, 5)
    assert port_report.watchdog_funnel(events) == \
        ref_report.watchdog_funnel(events)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", paths["ref"],
         "--top", "5"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(port_fleet.__file__).rsplit("/repro_torch",
                                                           1)[0],
             "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    header, events = ref_report.load_jsonl(paths["port"])
    assert proc.stdout.strip() == ref_report.render_report(
        header, events, 5).strip()


def test_report_rejects_other_kinds(tmp_path):
    path = tmp_path / "x.jsonl"
    path.write_text(json.dumps({"kind": "something.else"}) + "\n")
    with pytest.raises(ValueError, match="not a flight-recorder trace"):
        port_report.load_jsonl(str(path))
    assert port_obs.TRACE_KIND == ref_obs.TRACE_KIND
    assert port_obs.SCHEMA_VERSION == ref_obs.SCHEMA_VERSION


def test_json_sanitize_matches_reference():
    obj = {"a": float("inf"), "b": [np.float64(1.5), np.int64(3),
                                    float("nan")],
           "c": (np.bool_(True), {"d": -float("inf")}), "e": None}
    assert port_obs.json_sanitize(obj) == ref_obs.json_sanitize(obj)


def test_ring_buffer_drops_like_the_reference():
    recs = [port_obs.FlightRecorder(capacity=4),
            ref_obs.FlightRecorder(capacity=4)]
    for rec in recs:
        with pytest.warns(RuntimeWarning):
            for i in range(7):
                rec.emit(float(i), "node_fail", node=i)
    assert recs[0].to_jsonl() == recs[1].to_jsonl()
    assert recs[0].dropped == 3


def _caps(B=4, d=6, seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.uniform(10.0, 120.0, size=(B, d + 1, d + 1))
    for c in caps:
        np.fill_diagonal(c, 0.0)
    return caps


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_profile_hook_total_and_notes(engine):
    caps = _caps()
    bare = port_core.plan_many(torch.from_numpy(caps), PORT_PARAMS, "ftr",
                               engine=engine, device="cpu")
    prof = port_obs.PlannerProfile()
    got = port_core.plan_many(torch.from_numpy(caps), PORT_PARAMS, "ftr",
                              engine=engine, device="cpu", profile=prof)
    assert torch.equal(bare.times, got.times)
    s = prof.summary()
    ref_prof = ref_obs.PlannerProfile()
    ref_core.plan_many(caps, REF_PARAMS, "ftr", engine=engine,
                       profile=ref_prof)
    ref_s = ref_prof.summary()
    assert s["stages"]["total"]["calls"] == 1
    assert s["stages"]["total"]["ms"] >= 0
    assert set(s) == set(ref_s)
    for key in ("scheme", "batch", "d", "engine", "fallback"):
        assert s["meta"][key] == ref_s["meta"][key], key
    one = port_obs.PlannerProfile()
    port_core.plan(port_core.OverlayNetwork(caps[0].tolist()), PORT_PARAMS,
                   "tr", profile=one)
    assert one.summary()["meta"] == {"scheme": "tr", "batch": 1,
                                     "engine": "scalar"}
    assert one.summary()["stages"]["total"]["calls"] == 1


def test_profile_accumulates_like_the_reference():
    profs = [port_obs.PlannerProfile(), ref_obs.PlannerProfile()]
    for prof in profs:
        for _ in range(2):
            with prof.stage("a"):
                pass
        prof.add("b", 0.5, calls=3)
        prof.count("widgets", 3)
        prof.count("widgets", 2)
        prof.note(hello="world")
    s, r = (p.summary() for p in profs)
    assert s["counters"] == r["counters"] == {"widgets": 5}
    assert s["meta"] == r["meta"]
    assert s["stages"]["a"]["calls"] == 2
    assert s["stages"]["b"] == r["stages"]["b"] == {"calls": 3, "ms": 500.0}


def test_link_usage_tracer_matches_reference():
    out = []
    for obs in (port_obs, ref_obs):
        clock = [0.0]
        rec = obs.FlightRecorder()
        tr = obs.LinkUsageTracer(clock=lambda: clock[0], recorder=rec)
        for t, link, users in ((0.0, (1, 2), 1), (1.5, (1, 2), 2),
                               (2.0, (3, 1), 1), (4.0, (1, 2), 0)):
            clock[0] = t
            tr.on_users(link, users)
        tr.finish(5.0)
        tr.finish(5.0)
        out.append((tr.snapshot(), rec.to_jsonl()))
    assert out[0] == out[1]
    assert out[0][0]["links"]["1->2"] == {"busy_time": 4.0,
                                          "user_seconds": 6.5,
                                          "max_users": 2}
