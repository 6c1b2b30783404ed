"""Shared fixtures of the benchmark's CPU tests, and the ``chip`` marker
for the tests that need a CUDA card (they skip here, in a fixture)."""
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True)
def same_environment():
    """A run sets the caches' directories in the environment; put it back,
    and keep torch on one thread beside the suite's other workers."""
    import torch
    saved, threads = dict(os.environ), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    os.environ.clear()
    os.environ.update(saved)
    torch.set_num_threads(threads)
