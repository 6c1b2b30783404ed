"""The deepseek-v2-lite-ec8.train-mla cell end to end on the CPU at a small
size: a result line of the benchmark's shape, correct, and not correct
with each fault that the cell can have planted underneath it (the train
faults, a capacity router, and DeepSeek-V2's own: the softmax scale
without YaRN's mscale^2, the shared experts left out); the fp8 control
fails a limit; the step's FLOPs and the attention's bound by hand; the
configuration's published widths and parameter count.  On the card
(``chip``): a profiled eager step of the cell's share takes the fused
attention's (192, 128) variant at every call."""
import math
from unittest import mock

import pytest
import torch

import perfbench_cpu
from perfbench import gen, gen_mla
from perfbench.common import gap, worst_leaf_gap
from perfbench.reference import deepseek_v2
from perfbench.run import ROOT, read_json
from perfbench.tools.faults_mla import FAULTS_MLA

CELL = "deepseek-v2-lite-ec8.train-mla"
CONFIG = ROOT / "perfbench/configs/deepseek-v2-lite-ec8.json"
TINY_MLA = {"name": "dsv2-tiny", "family": "moe", "num_layers": 3,
            "d_model": 64, "d_ff": 32, "vocab_size": 256, "num_heads": 4,
            "num_kv_heads": 4, "head_dim": 24, "norm": "rmsnorm",
            "rope_theta": 10000.0, "tie_embeddings": False,
            "num_experts": 4, "experts_per_token": 3, "router_experts": 8,
            "expert_offset": 2, "norm_eps": 1e-6, "lb_weight": 0.001,
            "z_weight": 0.0, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "shared_experts": 2,
            "first_dense": 1, "dense_d_ff": 96, "rope_factor": 40.0,
            "rope_original": 16, "beta_fast": 32.0, "beta_slow": 1.0,
            "mscale": 0.707, "mscale_all_dim": 0.707,
            "param_dtype": "float32", "compute_dtype": "float32",
            "q_chunk": 16, "kv_chunk": 16, "loss_chunk": 16}
SIZES = {CELL: {"model": TINY_MLA, "batch": 4, "seq_len": 32,
                "batch_pool": 4}}


def run_cell(**kw):
    """The cell's CPU run; the process's device totals are cleared after
    it, so that a planted capacity router's drops stay out of the cells
    that later tests run in the same process."""
    from repro_torch.obs import spans
    try:
        with mock.patch.dict(perfbench_cpu.SIZES, SIZES):
            return perfbench_cpu.run_cell(CELL, **kw)
    finally:
        spans.reset()


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
    assert "held pairs a token and MoE layer" in err


@pytest.mark.parametrize("fault", sorted(FAULTS_MLA))
def test_fault_is_not_correct(fault):
    rc, res, err = run_cell(fault=FAULTS_MLA[fault])
    assert rc == 0, err
    assert res["correct"] is False, (fault, res["checks"])
    if fault == "capacity":
        assert res["checks"]["dropped_pairs"]["value"] > 0


def test_fp8_reference_fails_the_limits():
    cfg = read_json(CONFIG)
    mdl = dict(TINY_MLA, param_dtype="bfloat16", compute_dtype="bfloat16")
    batches = gen.lm_batches(5, mdl["vocab_size"], 2, 32, 3, 0.9, "cpu")
    runs = {}
    for prec in ("fp32", "fp8"):
        params = gen_mla.mla_weights(mdl, 5, "cpu", torch.bfloat16)
        runs[prec] = deepseek_v2.train_steps(params, mdl, cfg["optimizer"],
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
    from perfbench import roofline, roofline_mla
    model = read_json(CONFIG)["model"]
    # 5 layers of MLA (6,291,456 + 1,179,648 + 2,097,152 + 4,194,304),
    # layer 0's SwiGLU 3 x 2048 x 10,944, 4 MoE layers' router 2048 x 64
    # and shared experts 3 x 2048 x 2816, the head 102,400 x 2048
    assert roofline_mla.mla_matmul_params(model) == 13_762_560
    assert roofline_mla.dense_matmul_params(model) == \
        5 * 13_762_560 + 3 * 2048 * 10944 + 4 * (2048 * 64 + 3 * 2048 * 2816) \
        + 102400 * 2048 == 415_498_240
    # 16,384 tokens at 1.5 held pairs a token and MoE layer: about 51 TFLOP
    pairs = 1.5 * 16384 * 4
    flops = roofline_mla.train_step_flops(model, 16384, 4096, pairs)
    assert flops == 6 * 415_498_240 * 16384 + 18 * 2048 * 1408 * pairs \
        + 3 * 5 * 4096 * 16 * (192 + 128) * 16384
    assert 51.0e12 < flops < 51.2e12
    # a causal call at 2 x 4096 x 16: QK^T 192 and PV 128 forward; dQ, dK
    # at 192 and dP, dV at 128 backward; under remat two forward passes
    fwd, bwd = roofline_mla.attention_flops(2, 4096, 16, 192, 128)
    pairs_kept = 4096 * 4097 // 2
    assert fwd == 2 * 2 * 16 * pairs_kept * 320 and bwd == 2 * fwd
    pk = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    bound = roofline_mla.attention_bound_s(model, 2, 4096, 10, 2, pk)
    assert bound == pytest.approx(10 * (2 * fwd + bwd) / 989e12)


def test_the_configuration_states_the_published_widths():
    cfg = read_json(CONFIG)
    m = cfg["model"]
    assert (m["d_model"], m["d_ff"], m["num_heads"], m["head_dim"],
            m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
            m["v_head_dim"], m["dense_d_ff"], m["router_experts"],
            m["experts_per_token"], m["shared_experts"], m["vocab_size"]) \
        == (2048, 1408, 16, 192, 512, 128, 64, 128, 10944, 64, 6, 2, 102400)
    assert cfg["source_values"] == {"num_hidden_layers": 27,
                                    "n_routed_experts": 64}
    # the published config.json's keys, as the model the loop runs has them
    rope = cfg["rope_scaling"]
    assert (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["moe_intermediate_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["intermediate_size"],
            cfg["n_routed_experts"], cfg["num_experts_per_tok"],
            cfg["n_shared_experts"], cfg["first_k_dense_replace"],
            cfg["vocab_size"], cfg["rms_norm_eps"], cfg["rope_theta"],
            rope["factor"], rope["original_max_position_embeddings"],
            rope["beta_fast"], rope["beta_slow"], rope["mscale"],
            rope["mscale_all_dim"], cfg["tie_word_embeddings"]) \
        == (m["num_layers"], m["d_model"], m["d_ff"], m["num_heads"],
            m["num_kv_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"], m["dense_d_ff"],
            m["num_experts"], m["experts_per_token"], m["shared_experts"],
            m["first_dense"], m["vocab_size"], m["norm_eps"],
            m["rope_theta"], m["rope_factor"], m["rope_original"],
            m["beta_fast"], m["beta_slow"], m["mscale"],
            m["mscale_all_dim"], m["tie_embeddings"])
    assert cfg["q_lora_rank"] is None and cfg["norm_topk_prob"] is False
    assert (cfg["topk_method"], cfg["scoring_func"], cfg["seq_aux"],
            cfg["routed_scaling_factor"]) == ("greedy", "softmax", True, 1)
    from repro_torch.models import MLAShareConfig
    leaves = gen_mla.mla_leaves(m)
    held = 1_178_886_656
    assert sum(math.prod(s) for _, s, *_ in leaves) == held
    mc = MLAShareConfig(**m)
    assert mc.param_count() == held
    assert mc.softmax_scale == pytest.approx(0.114721, abs=1e-6)
    assert deepseek_v2.softmax_scale(m) == mc.softmax_scale
    assert set(cfg["limits"]) == set(cfg["limits_why"])


@pytest.mark.chip
def test_profiled_eager_step_counts_on_the_card(card):
    from repro_torch.models import MLAShareConfig, Transformer
    from repro_torch.obs import spans
    from repro_torch.train import EagerTrainStep, OptimizerConfig, init_opt
    cfg = read_json(CONFIG)
    mdl = dict(cfg["model"], num_layers=2)
    mc = MLAShareConfig(**mdl)
    oc = OptimizerConfig(**cfg["optimizer"])
    model = Transformer(mc, "cuda")
    w = gen_mla.mla_weights(mdl, 8, "cuda", torch.bfloat16)
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
    # 2 layers x 2 microbatches x (the forward and its recomputation)
    assert s["counters"]["attn.fused"]["traced"] == 8
    assert spans.total("attn.launches.forward.d192v128") == 8
    assert spans.total("attn.launches.backward.d192v128") == 4
    assert "attn.chunked" not in s["counters"]
    assert s["spans"]["moe.shared"]["calls"] == 4
