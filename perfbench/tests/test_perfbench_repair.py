"""The fig6-msr-d10.repair-b1 cell end to end on the CPU at a small size: a result line of
the benchmark's shape, correct, and not correct with each fault that the
cell can have planted underneath it."""
import math

import pytest

from perfbench.tools.faults import FAULTS
from perfbench_cpu import run_cell

CELL = "fig6-msr-d10.repair-b1"


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    rc, res, err = run_cell(CELL, trace=trace)
    assert rc == 0, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for name, m in res["metrics"].items():
        assert math.isfinite(m["value"]) and m["unit"], name
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in last] == list(res["checks"])


@pytest.mark.parametrize("fault", sorted(FAULTS["repair"]))
def test_fault_is_not_correct(fault):
    rc, res, err = run_cell(CELL, fault=FAULTS["repair"][fault])
    assert rc == 0, err
    assert res["correct"] is False, (fault, res["checks"])
