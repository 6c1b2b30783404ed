"""The port's launch modules (``repro_torch.launch``) on the CPU: meshes,
abstract inputs, the H100 roofline, the dry run, and a smoke config's
train step on a fake 2x2 mesh.

* Meshes: the production meshes are 16x16 and 2x16x16 over a ``fake``
  process group; the host mesh is 1x1 (gloo only when the CPU is named;
  without CUDA the default raises and starts no group).
* Specs: the meta model's parameters count ``param_count()``; the batch
  and cache specs have the reference's shapes and dtypes
  (``test_torch_sharding.py`` holds their placements);
  ``TRAIN_MICROBATCHES`` is the reference's.
* Roofline: the ring formulas and ``roofline_terms`` against hand values.
* Dry run: cells cut to one layer (``overrides``) are ``ok``, their
  argument bytes equal the sum by spec arithmetic, their counted FLOPs are
  at least ``model_flops_per_device``, every roofline term is finite, and
  no CUDA context was opened.
* Fake 2x2 mesh: olmo-1b's smoke config (no remat) trains one step;
  ``FlopCounterMode`` counts at least the analytic matmul FLOPs of the
  ideal split (every matmul over the data and model shards) and at most
  1.2 times them (DTensor computes the MLP's weight gradients unsplit over
  "model": it takes the residual stream's gradient as a partial sum and
  gathers the activations; 15.4 % more at this size), and collectives
  run where the rules shard.

Each test that starts a process group ends it in a finalizer.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.launch import specs as ref_specs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import (distribute_batch, distribute_model,
                                     param_shardings, set_mesh)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as port_specs
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     teardown)
from repro_torch.models import init_params
import repro_torch.train as PT


@pytest.fixture
def process_group():
    """Ends whatever default process group the test starts."""
    yield
    teardown()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                         "2x16x16"])
def test_production_mesh(multi_pod, process_group):
    import torch.distributed as dist
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == want
    assert dist.get_world_size() == math.prod(want[0])
    teardown()
    assert not dist.is_initialized()


def test_host_mesh(process_group, monkeypatch):
    import torch.distributed as dist
    mesh = make_host_mesh("cpu")
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == ((1, 1),
                                                        ("data", "model"))
    assert dist.get_backend() == "gloo"
    teardown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_are_the_references(arch):
    cfg = get_config(arch)
    model = port_specs.params_specs(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    from repro.configs import get_config as ref_config
    from repro_torch.models.config import SHAPES
    from repro_torch.configs import shape_cells
    for cell in shape_cells(arch):
        rin = ref_specs.input_specs(ref_config(arch), SHAPES[cell])
        pin = port_specs.input_specs(cfg, SHAPES[cell])
        assert set(pin) == set(rin)
        for key in ("tokens", "pos"):
            if key in rin:
                assert tuple(pin[key].shape) == rin[key].shape
                assert pin[key].dtype == getattr(torch, rin[key].dtype.name)


def test_train_microbatches_are_the_references():
    assert port_specs.TRAIN_MICROBATCHES == ref_specs.TRAIN_MICROBATCHES


def test_ring_formulas():
    size, n = 1000.0, 8
    assert roofline.link_bytes("all-reduce", size, n) == 2 * 7 / 8 * size
    assert roofline.link_bytes("all-gather", size, n) == 7 / 8 * size
    assert roofline.link_bytes("reduce-scatter", size, n) == 7 * size
    assert roofline.link_bytes("all-to-all", size, n) == 7 / 8 * size
    assert roofline.link_bytes("permute", size, n) == size
    assert roofline.link_bytes("all-reduce", size, 1) == 0.0
    with pytest.raises(ValueError):
        roofline.link_bytes("gather", size, n)


def test_roofline_terms_by_hand():
    t = roofline.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["t_compute"], t["t_memory"], t["t_collective"]) == \
        (1.0, 2.0, 0.5)
    assert t["dominant"] == "t_memory" and t["bound_s"] == 2.0
    assert t["roofline_fraction"] == 0.5
    assert roofline.roofline_terms(0.0, 0.0, 0.0)["roofline_fraction"] == 0.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("yi-6b", "train_4k", False), ("kimi-k2-1t-a32b", "train_4k", True),
    ("yi-6b", "decode_32k", False)])
def test_dryrun_cell_cut_to_one_layer(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod,
                          overrides=dict(num_layers=1))
    assert rec["ok"], rec.get("error")
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["analytic_argument_bytes"] > 0
    assert mem["temp_bytes"] > 0
    assert rec["flops_per_device"] >= rec["model_flops_per_device"] > 0
    assert 0 < rec["useful_fraction"] <= 1
    assert all(math.isfinite(v) for v in rec["roofline"].values()
               if isinstance(v, float))
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["cuda_initialized"] is False
    if shape == "train_4k":
        assert rec["collective_counts"]
        assert rec["collective_link_bytes_per_device"] > 0


def _ideal_flops(cfg, B, S, data, model):
    """Forward matmul FLOPs of one device when every matmul splits over
    the data shards (tokens) and the model shards (heads, d_ff, vocab),
    times 3 (the backward's two products a matmul; no remat)."""
    T = B // data * S
    d, H, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    KV = cfg.num_kv_heads
    proj = 2 * T * d * (2 * H + 2 * KV) * hd // model
    mlp = 3 * 2 * T * d * f // model
    qc, kc = min(cfg.q_chunk, S), min(cfg.kv_chunk, S)
    attn = 2 * 2 * (B // data) * (H // model) * (S // qc) * (S // kc) * \
        qc * kc * hd
    loss = 2 * T * d * cfg.vocab_size // model
    return 3 * (cfg.num_layers * (proj + mlp + attn) + loss)


def test_smoke_step_on_a_fake_2x2_mesh(process_group):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), remat=False)
    model = init_params(cfg, 0, device="cpu")
    sh = param_shardings(mesh, model, fsdp=True)
    distribute_model(model, mesh, sh)
    ocfg = PT.OptimizerConfig()
    step = PT.make_train_step(cfg, ocfg, n_micro=1, grad_shardings=sh)
    opt = PT.init_opt(ocfg, model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    B, S = 4, 32
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    with set_mesh(mesh), dryrun._quiet_propagation():
        got = dryrun._measure(lambda: step(model, opt,
                                           distribute_batch(batch, mesh)))
    ideal = _ideal_flops(cfg, B, S, 2, 2)
    assert ideal <= got["flops"] <= 1.2 * ideal, (got["flops"], ideal)
    assert got["calls"].get("all-gather", 0) > 0       # FSDP's gathers
    assert got["calls"].get("reduce-scatter", 0) > 0   # grad_shardings
    assert got["calls"].get("all-reduce", 0) > 0       # the residual stream
    assert got["hbm_bytes"] > 0
