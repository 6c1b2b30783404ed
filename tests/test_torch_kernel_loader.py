"""The hand kernels' shared plumbing (``repro_torch.kernels.nvcc.load``)
and what every wrapper refuses, on the CPU.

Each wrapper's ``library()`` runs here against a stand-in for
``ctypes.CDLL`` (no ``nvcc``, no card): the library's geometry must equal
the wrapper's or loading raises and names the source; the wrapper declares
its launches; a nonzero code from an entry point raises with the library's
own error string.  Each wrapper refuses CPU tensors with a ValueError
before anything is built, and counts no launch.
"""
import ctypes
import importlib
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import moe_gather as kmg
from repro_torch.obs import spans

# the module: the package's name ``gf_matmul`` is the dispatcher function
kgf = importlib.import_module("repro_torch.kernels.gf_matmul")

# module, how a test opens its library, its geometry, its launch symbols
WRAPPERS = {
    "gf_matmul": (kgf, lambda: kgf.library(), kgf.GEOMETRY,
                  ("gf256_init", "gf256_matmul_launch")),
    "attention": (kattn, lambda: kattn.library(128, True),
                  (kattn.TILE, 128, 1, kattn.THREADS),
                  ("attn_forward", "attn_backward")),
    "adamw": (kadamw, lambda: kadamw.library(), kadamw.GEOMETRY,
              ("adamw_sumsq_launch", "adamw_update_launch")),
    "moe_gather": (kmg, lambda: kmg.library(), kmg.GEOMETRY,
                   ("moe_gather_sum_launch", "moe_combine_backward_launch")),
}


class StandIn:
    """``ctypes.CDLL``'s stand-in: ``<prefix>_geometry`` reports
    ``geometry``, ``<prefix>_error_string`` names a code, and every other
    symbol returns 0.  A symbol is a function, so it takes ``argtypes`` and
    ``restype`` as a ctypes function does."""

    def __init__(self, path, geometry):
        self.path, self.geometry = path, geometry

    def __getattr__(self, name):
        if name.endswith("_geometry"):
            def symbol(buf):
                for i, x in enumerate(self.geometry):
                    buf[i] = x
        elif name.endswith("_error_string"):
            def symbol(err):
                return f"stand-in error {err}".encode()
        else:
            def symbol(*args):
                return 0
        setattr(self, name, symbol)
        return symbol


@pytest.fixture
def stand_in(monkeypatch):
    """Every wrapper's build returns a path that is never opened and
    ``ctypes.CDLL`` gives a :class:`StandIn`; the fixture's value sets the
    geometry the stand-in reports.  The wrappers' cached libraries are
    dropped afterwards."""
    reported = {}
    for module, *_ in WRAPPERS.values():
        monkeypatch.setattr(module, "build_library",
                            lambda *job: (pathlib.Path("stand-in.so"), ""))
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda path: StandIn(path, reported["geometry"]))
    yield lambda geometry: reported.update(geometry=geometry)
    for module, *_ in WRAPPERS.values():
        module.library.cache_clear()


@pytest.mark.parametrize("name", WRAPPERS)
def test_library_refuses_another_geometry(stand_in, name):
    module, open_library, want, _ = WRAPPERS[name]
    got = want[:-1] + (want[-1] + 1,)
    stand_in(got)
    with pytest.raises(RuntimeError, match=re.escape(
            f"{module.SOURCE.name} has geometry {got}, the wrapper {want}")):
        open_library()


@pytest.mark.parametrize("name", WRAPPERS)
def test_library_declares_launches_and_checks_codes(stand_in, name):
    """At the wrapper's geometry the library loads, its launches are
    declared as returning an int code, a zero code passes and a nonzero
    one raises with the library's own error string."""
    _, open_library, want, launches = WRAPPERS[name]
    stand_in(want)
    lib = open_library()
    for symbol in launches:
        assert getattr(lib, symbol).restype is ctypes.c_int
        assert isinstance(getattr(lib, symbol).argtypes, list)
    lib.check(0, "a launch")
    with pytest.raises(RuntimeError, match=re.escape(
            "a launch failed: stand-in error 7 (7)")):
        lib.check(7, "a launch")


def _gf_on_cpu():
    a = torch.zeros((4, 4), dtype=torch.uint8)
    kgf.gf_matmul_cuda(a, a)


def _attention_on_cpu():
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    kattn.fused_attention(q, q, q, torch.arange(64), causal=True)


def _adamw_on_cpu():
    shapes = [(4, 8), (16,)]
    params, grads, m, v = ([torch.zeros(s) for s in shapes]
                           for _ in range(4))
    kadamw.FusedAdamW()(params, grads, m, v,
                        torch.zeros((), dtype=torch.int32), 1e-3, b1=0.9,
                        b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)


def _moe_gather_on_cpu():
    row = torch.zeros((4, 2), dtype=torch.int64)
    kmg.gather_sum(torch.zeros((8, 16)), row, row > 0,
                   torch.ones((4, 2)))


@pytest.mark.parametrize("name, call, counter", [
    ("gf_matmul", _gf_on_cpu, "gf.launches"),
    ("attention", _attention_on_cpu, "attn.launches.forward"),
    ("adamw", _adamw_on_cpu, "optim.launches"),
    ("moe_gather", _moe_gather_on_cpu, "moe.gather.launches"),
])
def test_wrapper_refuses_cpu_tensors(monkeypatch, name, call, counter):
    """No fallback: a wrapper raises on what it cannot launch on, before
    anything is built."""
    monkeypatch.setattr(WRAPPERS[name][0], "build_library", pytest.fail)
    spans.reset()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert spans.total(counter) == 0
