"""The olmoe-1b-7b-ec8.train-moe cell end to end on the CPU at a small
size: a result line of the benchmark's shape, correct, and not correct
with each fault that the cell can have planted underneath it; the fp8
control fails a limit.  On the card (``chip``): the expert share's train
step through the graph bitwise its eager step, and a profiled eager step
that drops no pair and takes the fused attention at every call."""
import math
from unittest import mock

import pytest
import torch

import perfbench_cpu
from perfbench import gen, gen_moe
from perfbench.common import gap, worst_leaf_gap
from perfbench.reference import olmoe
from perfbench.run import ROOT, read_json
from perfbench.tools.faults_moe import FAULTS_MOE

CELL = "olmoe-1b-7b-ec8.train-moe"
TINY_MOE = {"name": "olmoe-tiny", "family": "moe", "num_layers": 2,
            "d_model": 64, "d_ff": 32, "vocab_size": 256, "num_heads": 4,
            "num_kv_heads": 4, "head_dim": 16, "norm": "rmsnorm",
            "rope_theta": 10000.0, "tie_embeddings": False,
            "num_experts": 4, "experts_per_token": 4, "router_experts": 8,
            "expert_offset": 2, "norm_eps": 1e-5,
            "lb_weight": 0.01, "z_weight": 0.001, "param_dtype": "float32",
            "compute_dtype": "float32", "q_chunk": 16, "kv_chunk": 16,
            "loss_chunk": 16}
SIZES = {CELL: {"model": TINY_MOE, "batch": 4, "seq_len": 32,
                "batch_pool": 4}}


def run_cell(**kw):
    with mock.patch.dict(perfbench_cpu.SIZES, SIZES):
        return perfbench_cpu.run_cell(CELL, **kw)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    rc, res, err = run_cell(trace=trace)
    assert rc == 0, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["loss_gap", "grad_norm_gap",
                                   "change_gap", "ckpt_wrong_bytes",
                                   "route_gap", "dropped_pairs"]
    assert res["checks"]["route_gap"]["value"] == 0
    assert res["checks"]["dropped_pairs"]["value"] == 0
    for name, m in res["metrics"].items():
        assert math.isfinite(m["value"]) and m["unit"], name
    if not trace:
        assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert "held pairs a token and layer" in err


@pytest.mark.parametrize("fault", sorted(FAULTS_MOE))
def test_fault_is_not_correct(fault):
    rc, res, err = run_cell(fault=FAULTS_MOE[fault])
    assert rc == 0, err
    assert res["correct"] is False, (fault, res["checks"])
    if fault == "capacity":
        assert res["checks"]["dropped_pairs"]["value"] > 0


def test_fp8_reference_fails_the_limits():
    cfg = read_json(ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
    mdl = dict(TINY_MOE, param_dtype="bfloat16", compute_dtype="bfloat16")
    batches = gen.lm_batches(5, mdl["vocab_size"], 2, 32, 3, 0.9, "cpu")
    runs = {}
    for prec in ("fp32", "fp8"):
        params = gen_moe.moe_weights(mdl, 5, "cpu", torch.bfloat16)
        runs[prec] = olmoe.train_steps(params, mdl, cfg["optimizer"],
                                       batches, 2, prec)
    ref32, ctl = runs["fp32"], runs["fp8"]
    readings = {
        "loss_gap": max(gap(a, b) for a, b in zip(ctl["losses"],
                                                  ref32["losses"])),
        "grad_norm_gap": worst_leaf_gap(ctl["grad_norms"],
                                        ref32["grad_norms"]),
        "change_gap": worst_leaf_gap(ctl["change_norms"],
                                     ref32["change_norms"])}
    assert any(v > cfg["limits"][k] for k, v in readings.items()), readings


def test_flops_and_bound_by_hand():
    from perfbench import roofline, roofline_moe
    cfg = read_json(ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
    model = cfg["model"]
    # 8 layers of 4 * 2048 * 2048 + 2048 * 64, and the head 50,304 * 2048
    assert roofline_moe.dense_matmul_params(model) == \
        8 * (4 * 2048 * 2048 + 2048 * 64) + 50304 * 2048 == 238_288_896
    # 16,384 tokens at 2 held pairs a token and layer: about 40 TFLOP
    pairs = 2 * 16384 * 8
    flops = roofline_moe.train_step_flops(model, 16384, 4096, pairs)
    assert flops == 6 * 238_288_896 * 16384 + 18 * 2048 * 1024 * pairs \
        + 6 * 8 * 4096 * 16 * 128 * 16384
    assert 39.8e12 < flops < 40.0e12
    # operation-bound at 16,384 pairs a call: 24 d f a pair under remat
    pk = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    bound = roofline_moe.expert_products_bound_s(model, 16384.0, 1, 2, pk)
    assert bound == pytest.approx(24 * 2048 * 1024 * 16384 / 989e12)


def test_the_configuration_states_the_published_widths():
    cfg = read_json(ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
    m = cfg["model"]
    assert (m["d_model"], m["d_ff"], m["num_heads"], m["head_dim"],
            m["router_experts"], m["experts_per_token"], m["vocab_size"]) \
        == (2048, 1024, 16, 128, 64, 8, 50304)
    assert cfg["source_values"] == {"num_layers": 16, "num_experts": 64}
    from repro_torch.models import MoEShareConfig
    leaves = gen_moe.moe_leaves(m)
    # 1.147 B parameters held: attention 134.2 M, experts 805.3 M,
    # routers and norms 1.1 M, embedding and head 206.0 M
    held = 8 * 4 * 2048 * 2048 + 8 * 16 * 3 * 2048 * 1024 \
        + 8 * (2048 * 64 + 4 * 2048) + 2 * 50304 * 2048 + 2048
    assert held == 1_146_685_440
    assert sum(math.prod(s) for _, s, *_ in leaves) == held
    assert MoEShareConfig(**m).param_count() == held
    assert set(cfg["limits"]) == set(cfg["limits_why"])


@pytest.mark.chip
def test_graph_is_bitwise_eager_on_the_card(card):
    from repro_torch.models import MoEShareConfig, Transformer
    from repro_torch.train import (EagerTrainStep, OptimizerConfig,
                                   TrainGraph, init_opt)
    cfg = read_json(ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
    mdl = dict(cfg["model"], num_layers=2)
    mc = MoEShareConfig(**mdl)
    oc = OptimizerConfig(**cfg["optimizer"])
    batches = gen.lm_batches(7, mdl["vocab_size"], 2, 1024, 3, 0.9, "cuda")
    out = {}
    for kind in (EagerTrainStep, TrainGraph):
        model = Transformer(mc, "cuda")
        w = gen_moe.moe_weights(mdl, 7, "cuda", torch.bfloat16)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(w[n])
        opt = init_opt(oc, model, device="cuda")
        run = kind(mc, oc, model, opt, n_micro=2)
        losses = [float(run({"tokens": t, "labels": y})["loss"])
                  for t, y in batches]
        out[kind.__name__] = (losses, [p.detach().clone()
                                       for p in model.parameters()])
        del run, model, opt
    (le, pe), (lg, pg) = out["EagerTrainStep"], out["TrainGraph"]
    assert le == lg
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))


@pytest.mark.chip
def test_profiled_eager_step_counts_on_the_card(card):
    from repro_torch.models import MoEShareConfig, Transformer
    from repro_torch.obs import spans
    from repro_torch.train import EagerTrainStep, OptimizerConfig, init_opt
    cfg = read_json(ROOT / "perfbench/configs/olmoe-1b-7b-ec8.json")
    mdl = cfg["model"]
    mc = MoEShareConfig(**mdl)
    oc = OptimizerConfig(**cfg["optimizer"])
    model = Transformer(mc, "cuda")
    w = gen_moe.moe_weights(mdl, 8, "cuda", torch.bfloat16)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    del w
    opt = init_opt(oc, model, device="cuda")
    run = EagerTrainStep(mc, oc, model, opt, n_micro=cfg["n_micro"])
    (tok, lab), = gen.lm_batches(8, mdl["vocab_size"], cfg["batch"],
                                 cfg["seq_len"], 1, 0.9, "cuda")
    spans.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        float(run({"tokens": tok, "labels": lab})["loss"])
    s = spans.summary()
    assert spans.device_total("moe.dropped") == 0
    pairs = spans.device_total("moe.pairs")
    tokens = cfg["batch"] * cfg["seq_len"] * mdl["num_layers"]
    assert 1.0 <= pairs / tokens <= 4.0
    # 8 layers x 2 microbatches x (the forward and its recomputation)
    assert s["counters"]["attn.fused"]["traced"] == 32
    assert "attn.chunked" not in s["counters"]
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                 "moe.aux"):
        assert s["spans"][name]["calls"] == 32, name
