"""Shared test configuration.

Some test modules import ``hypothesis`` at the top level; CI installs it
(requirements-ci.txt) but minimal local environments may not have it.  Skip
collecting those modules instead of erroring the whole run — the seeded
non-hypothesis tests still provide coverage (e.g. tests/test_witness.py
keeps its deterministic sweep).
"""
import importlib.util
import pathlib

collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    _here = pathlib.Path(__file__).parent
    # only unconditional (column-0) imports make a module uncollectable;
    # modules that guard the import (e.g. tests/test_witness.py) still run
    collect_ignore = sorted(
        p.name for p in _here.glob("test_*.py")
        if any(line.startswith(("from hypothesis import",
                                "import hypothesis"))
               for line in p.read_text(encoding="utf-8").splitlines())
    )


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")
