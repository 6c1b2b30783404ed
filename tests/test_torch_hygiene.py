"""Boundaries of the port: it imports neither jax nor the reference package,
and it never runs on the CPU unless asked to.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device
from repro_torch.coding import GF8, RLNC
from repro_torch.core import CodeParams
from repro_torch.kernels import gf_matmul_numpy
from repro_torch.storage import RlncSimulator, reconstruction_vs_rounds, uniform

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).replace(
        ".__init__", "")
    for p in PORT.rglob("*.py"))


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 25
    assert {f"repro_torch.core.{m}" for m in (
        "batched", "torch_engine", "infoflow", "ort", "extensions")} \
        <= set(MODULES)
    assert {f"repro_torch.ft.{m}" for m in (
        "erasure", "checkpoint", "executor", "planner", "walkthrough")} \
        <= set(MODULES)
    assert {f"repro_torch.models.{m}" for m in (
        "config", "layers", "moe", "ssd", "transformer", "convert")} \
        <= set(MODULES)
    assert {"repro_torch.configs", "repro_torch.configs.yi_6b"} <= set(MODULES)
    assert {f"repro_torch.train.{m}" for m in (
        "optimizer", "step", "data", "loop", "train_lm")} <= set(MODULES)
    assert {"repro_torch.train", "repro_torch.serve",
            "repro_torch.serve.engine", "repro_torch.serve.serve_lm"} \
        <= set(MODULES)
    assert {"repro_torch.distributed.sharding",
            "repro_torch.distributed.hints", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.quickstart"} \
        <= set(MODULES)


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted(PORT.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_meta_only_for_the_dry_run(no_cuda):
    """``"meta"`` is a device only through ``allow_meta=True``, which the
    dry run's specs pass; every other entry point raises for it, and for
    the default device without CUDA."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import Transformer, init_cache, init_params
    from repro_torch.train import OptimizerConfig, init_opt
    assert resolve_device("meta", allow_meta=True) == torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(allow_meta=True)
    cfg = get_smoke_config("yi-6b")
    for make in (lambda: resolve_device("meta"),
                 lambda: Transformer(cfg, "meta"),
                 lambda: init_params(cfg, device="meta"),
                 lambda: init_cache(cfg, 1, 4, device="meta"),
                 lambda: RlncSimulator(CodeParams.msr(n=8, k=2, d=4, M=6.0),
                                       device="meta"),
                 lambda: init_opt(OptimizerConfig(),
                                  {"w": torch.ones(2)}, device="meta")):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            make()
    model = specs.params_specs(cfg)
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert {t.device.type for t in specs.cache_specs(cfg, 1, 4).values()} \
        == {"meta"}


def test_entry_points_raise_without_cuda(no_cuda):
    params = CodeParams.msr(n=8, k=2, d=4, M=6.0)
    with pytest.raises(RuntimeError):
        RlncSimulator(params)
    with pytest.raises(RuntimeError):
        RLNC(GF8)
    with pytest.raises(RuntimeError):
        reconstruction_vs_rounds(params, "ftr", uniform(), 1, 1)
    a = np.ones((2, 2), np.uint8)
    with pytest.raises(RuntimeError):
        gf_matmul_numpy(a, a)
    sim = RlncSimulator(params, device="cpu")
    assert sim.file_blocks.device.type == "cpu"


def test_ft_and_models_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.ft import ErasureCoder, tree_to_bytes, walkthrough
    from repro_torch.models import Transformer, init_cache, init_params
    cfg = get_smoke_config("yi-6b")
    for make in (ErasureCoder, lambda: tree_to_bytes({"a": torch.ones(2)}),
                 lambda: init_params(cfg), lambda: Transformer(cfg),
                 lambda: init_cache(cfg, 1, 4), lambda: walkthrough.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert ErasureCoder(device="cpu").device == torch.device("cpu")
    assert init_params(cfg, device="cpu").device == torch.device("cpu")


def test_train_and_serve_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_lm
    from repro_torch.train import (DataConfig, LoopConfig, OptimizerConfig,
                                   SyntheticLM, init_opt, train, train_lm)
    cfg = get_smoke_config("olmo-1b")
    model = init_params(cfg, device="cpu")
    for make in (lambda: train(cfg, DataConfig(batch=2, seq_len=8),
                               OptimizerConfig(), LoopConfig(steps=1)),
                 lambda: ServeEngine(cfg, model),
                 lambda: SyntheticLM(DataConfig(), cfg),
                 lambda: init_opt(OptimizerConfig(), model),
                 lambda: train_lm.main([]), lambda: serve_lm.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert SyntheticLM(DataConfig(), cfg, device="cpu").perm.device.type \
        == "cpu"
    assert init_opt(OptimizerConfig(), model, device="cpu").step.device \
        == torch.device("cpu")
    assert ServeEngine(cfg, model, device="cpu").device == \
        torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits nonzero
    and prints no result."""
    script = (ROOT / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        code = ("import sys, torch\n"
                "torch.cuda.is_available = lambda: False\n"
                f"sys.argv = [{str(path)!r}]\n"
                f"exec(compile(open({str(path)!r}).read(), {str(path)!r}, "
                "'exec'), {'__name__': '__main__', '__file__': "
                f"{str(path)!r}}})\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={"PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
