"""What the benchmark's sources may import, and its manifest's shape."""
import ast
import json
import math
import re

import pytest

from perfbench.run import HERE, ROOT, metrics_of, read_json

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path
        assert "benchmarks" not in imported_tops(path), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in imported_tops(path), path


def test_the_import_check_compares_whole_names():
    # repro_torch begins with repro: only the whole top-level name counts
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_without_a_card_the_run_prints_nothing_and_fails(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from perfbench import run
    assert run.main(["--workload", "fig6-msr-d10.plan-bulk", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_names_and_files():
    m = read_json(ROOT / "BENCHMARK.json")
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in m["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = metrics_of(m, w, False)
        assert "setup_s" in [x["name"] for x in reported]
        assert len(reported) >= 2 and metrics_of(m, w, True)
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{x['name']}.py").is_file()
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in (
            "host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e


def test_run_seconds_fit_a_full_check_of_24_cells():
    m = read_json(ROOT / "BENCHMARK.json")
    rs = m["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert not math.isnan(rs)
