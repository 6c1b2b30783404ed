"""Spans and counters inside the port (``repro_torch.obs.spans``), on the
CPU.

Without a profiler a span makes no ``record_function`` and no tally, while
the counters' totals move.  Under ``torch.profiler`` a plan emits
``plan.many``, every FTR stage and the loops' spans as profiler events whose counts the
tallies match, self time is at most total time, the engine's traced reads
by site sum to ``torch_engine.syncs``' move, and the plan is bitwise the
unprofiled one; a repair's execution emits ``repair.execute`` over its
``rlnc.*`` spans and launches no kernel.  The benchmark's three readers of
the tallies compute from hand-set ones.
"""
import collections
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core
from repro_torch.core import torch_engine
from repro_torch.obs import spans
from repro_torch.storage.simulator import RlncSimulator

ROOT = pathlib.Path(__file__).resolve().parents[1]
FTR_STAGES = ("tr_seed", "candidates", "local_search", "final_solve",
              "witness")
ENGINE_SITES = ("waterfill", "double", "star.ok", "fr.rest", "shah.need",
                "candidates.lanes", "candidates.solve", "local_search.probe",
                "local_search.lanes", "local_search.running")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def clean_tallies():
    spans.reset()
    yield
    spans.reset()


def _params():
    return core.CodeParams.msr(n=12, k=3, d=6, M=600.0)


def _caps(B, d=6, seed=7):
    rng = np.random.default_rng([seed, B])
    caps = rng.uniform(10.0, 120.0, size=(B, d + 1, d + 1))
    caps[:, np.arange(d + 1), np.arange(d + 1)] = 0.0
    return torch.from_numpy(caps)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _event_counts(prof):
    return collections.Counter(e.name for e in prof.events())


def _assert_same_plan(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def test_off_no_record_function_no_tally_counters_move(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span entered record_function while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    syncs = torch_engine.syncs
    res = core.plan_many(_caps(4), _params(), "ftr", device="cpu")
    core.plans_from_batch(res, _params())
    with spans.span("plan.many", {"B": 1}):
        pass
    summary = spans.summary()
    assert summary["spans"] == {} and summary["products"] == []
    reads = {n: c for n, c in summary["counters"].items()
             if n.startswith("plan.reads.")}
    assert sum(c["total"] for n, c in reads.items()
               if n != "plan.reads.unpack") == torch_engine.syncs - syncs > 0
    assert reads["plan.reads.unpack"]["total"] == 1
    assert all(c["traced"] == 0 for c in summary["counters"].values())


@pytest.mark.parametrize("B", [1, 64])
def test_plan_many_under_the_profiler_emits_its_stages(B):
    caps, params = _caps(B), _params()
    syncs = torch_engine.syncs
    res, prof = _profiled(lambda: core.plan_many(caps, params, "ftr",
                                                 device="cpu"))
    events = _event_counts(prof)
    summary = spans.summary()
    names = (["plan.many", "plan.waterfill", "plan.bisect",
              "plan.ftr.local_search.probe"]
             + [f"plan.ftr.{s}" for s in FTR_STAGES])
    for name in names:
        assert events[name] >= 1, name
        assert summary["spans"][name]["calls"] == events[name], name
    assert events["plan.many"] == 1
    for name, s in summary["spans"].items():
        assert 0.0 <= s["self_ms"] <= s["ms"], name
    engine_reads = sum(summary["counters"].get(f"plan.reads.{site}",
                                               {"traced": 0})["traced"]
                       for site in ENGINE_SITES)
    assert engine_reads == torch_engine.syncs - syncs > 0
    assert set(n for n in summary["counters"] if n.startswith("plan.reads."))\
        <= {f"plan.reads.{site}" for site in ENGINE_SITES}
    _assert_same_plan(core.plan_many(caps, params, "ftr", device="cpu"), res)


def test_profile_reads_are_not_the_engines():
    """With a ``PlannerProfile`` the stages still open once each, and the
    profile's own reads go under ``plan.reads.profile``, outside
    ``syncs``."""
    from repro_torch.obs import PlannerProfile
    caps, params = _caps(8), _params()
    syncs = torch_engine.syncs
    plain = core.plan_many(caps, params, "fr", device="cpu")
    plain_syncs = torch_engine.syncs - syncs
    spans.reset()
    syncs = torch_engine.syncs
    prof = PlannerProfile()
    got, tp = _profiled(lambda: core.plan_many(caps, params, "fr",
                                               device="cpu", profile=prof))
    _assert_same_plan(plain, got)
    assert torch_engine.syncs - syncs == plain_syncs
    counters = spans.summary()["counters"]
    assert counters["plan.reads.profile"]["traced"] >= 1
    assert sum(c["traced"] for n, c in counters.items()
               if n != "plan.reads.profile") == plain_syncs
    assert _event_counts(tp)["plan.fr.closed_form"] == 1
    assert list(prof.summary()["stages"]) == ["closed_form", "total"]


def test_execute_plan_emits_repair_and_coding_spans():
    params = core.CodeParams.msr(n=8, k=2, d=4, M=6.0)
    sim = RlncSimulator(params, block_bytes=16, seed=3, device="cpu")
    caps = _caps(1, d=4, seed=5)
    [pl] = core.plans_from_batch(core.plan_many(caps, params, "ftr",
                                                device="cpu"), params)
    launches = spans.total("gf.launches")
    _, prof = _profiled(lambda: sim.execute_plan(pl, 0, [1, 2, 3, 4]))
    assert spans.total("gf.launches") == launches == 0
    by_name = collections.defaultdict(list)
    for e in prof.events():
        by_name[e.name].append(e)
    [execute] = by_name["repair.execute"]
    assert by_name["rlnc.encode"] and len(by_name["rlnc.regenerate"]) == 1
    for name in ("rlnc.encode", "rlnc.relay", "rlnc.regenerate"):
        for e in by_name[name]:
            parent = e.cpu_parent
            while parent is not None and parent.name != "repair.execute":
                parent = parent.cpu_parent
            assert parent is execute, name
    tally = spans.summary()["spans"]
    assert tally["repair.execute"]["calls"] == 1
    assert tally["rlnc.encode"]["calls"] == len(by_name["rlnc.encode"])
    assert tally["repair.execute"]["self_ms"] < tally["repair.execute"]["ms"]


def test_checkpoint_save_emits_flatten_and_encode():
    from repro_torch import ft
    fleet = ft.Fleet(ft.FleetConfig(num_pods=2, hosts_per_pod=8), seed=0)
    coder = ft.ErasureCoder(n=8, k=4, d=6, blocks_per_host=8, seed=0,
                            device="cpu")
    ckpt = ft.ECCheckpoint(fleet, coder, hosts=list(range(8)), seed=0)
    state = {"w": torch.arange(300, dtype=torch.float32), "step": 3}
    _, prof = _profiled(lambda: ckpt.save(state, step=3))
    parents = {e.name: e.cpu_parent.name if e.cpu_parent else None
               for e in prof.events() if e.name.startswith("ckpt.")}
    assert parents == {"ckpt.save": None, "ckpt.flatten": "ckpt.save",
                       "ckpt.encode": "ckpt.save"}
    tally = spans.summary()["spans"]
    assert tally["ckpt.save"]["self_ms"] <= tally["ckpt.save"]["ms"]


def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ctx:
    def __init__(self, device):
        self.device = torch.device(device)


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    return {n: _reader(n) for n in ("plan_syncs.b1", "gf_roofline.repair",
                                    "ckpt_release_ms")}


def test_readers_compute_from_hand_set_tallies(readers):
    from perfbench import roofline
    card = _Ctx("cuda")
    for r in readers.values():
        assert r.read(None, card) is None            # nothing profiled
    spans._spans.update({"plan.many": [4, 1.0, 0.1],
                         "train.release": [1, 0.125, 0.125]})
    spans._totals.update({"plan.reads.waterfill": 900,
                          "plan.reads.local_search.probe": 120,
                          "plan.reads.unpack": 4,
                          "plan.reads.profile": 40})
    spans._traced.update({"plan.reads.waterfill": 600,
                          "plan.reads.local_search.probe": 100,
                          "plan.reads.unpack": 4,
                          "plan.reads.profile": 40})
    shapes = {(8, 48, 4 << 20, "aligned"): [10, 0.004],
              (48, 80, 4 << 20, "aligned"): [1, 0.002]}
    spans._products.update({k: list(v) for k, v in shapes.items()})
    assert readers["plan_syncs.b1"].read(None, card) == 700 / 4
    assert readers["ckpt_release_ms"].read(None, card) == 125.0
    pk = roofline.peaks(H100)
    bound = sum(c * roofline.gf_product_bound_s(m, k, n, pk)
                for (m, k, n, _), (c, _) in shapes.items())
    got = readers["gf_roofline.repair"].read(None, card)
    assert got == pytest.approx(100.0 * bound / 0.006, rel=1e-12)
    assert 0.0 < got <= 100.0
    for r in readers.values():
        assert r.read(None, _Ctx("cpu")) is None      # no card, no reading
