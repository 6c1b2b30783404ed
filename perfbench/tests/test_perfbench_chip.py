"""Every cell of BENCHMARK.json for a short window on the card, through
the benchmark's own command line (skips without a card)."""
import contextlib
import io
import json

import pytest

from perfbench import run

CELLS = [w["name"] for w in run.read_json(run.ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "2147483702",
                       "--seconds", "3", "--trace", "0"])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
