"""The training loop's step buffers (``repro_torch.train.graph``), which the
card captures as one CUDA graph, on the CPU at the smoke configs:

  * ``EagerTrainStep`` is bitwise ``make_train_step`` over 3 steps (losses,
    grad norms, parameters, moments, the step counter), at every smoke
    config with one and two microbatches;
  * the loop runs through it: a run with a host failure replays the
    uninterrupted run bitwise, and the restore writes the live
    ``OptState.step`` that the step buffers hold;
  * one step reads nothing on the host (a captured graph replays no host
    read), under the dispatch mode of ``test_torch_decode_graph.py``;
  * ``TrainGraph`` refuses a model on the CPU.

The graph itself (capture and replay) needs the card: ``chip_smoke.py``
phase 7b holds it to the eager step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import init_params
from repro_torch.train import (DataConfig, EagerTrainStep, LoopConfig,
                               OptimizerConfig, SyntheticLM, TrainGraph,
                               init_opt, make_train_step, train)
from repro_torch.train import loop as loopmod
from test_torch_decode_graph import NoHostReads
from test_torch_serve import tiny_cfg
from test_torch_train import one_torch_thread  # noqa: F401

STEPS = 3
OPT = OptimizerConfig(lr=1e-3)


def fresh(cfg, seed=0):
    model = init_params(cfg, seed, device="cpu")
    return model, init_opt(OPT, model, device="cpu")


def batches(cfg, n=STEPS):
    data = SyntheticLM(DataConfig(seed=5, batch=4, seq_len=16), cfg,
                       device="cpu")
    return [data.batch_at(i) for i in range(n)]


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_eager_train_step_is_make_train_step(arch, n_micro):
    cfg = get_smoke_config(arch)
    model, opt = fresh(cfg)
    ref_model, ref_opt = fresh(cfg)
    runner = EagerTrainStep(cfg, OPT, model, opt, n_micro=n_micro)
    step_fn = make_train_step(cfg, OPT, n_micro=n_micro)
    step_tensor = opt.step
    for i, batch in enumerate(batches(cfg)):
        got = runner(batch)
        ref_model, ref_opt, want = step_fn(ref_model, ref_opt, batch)
        for key in ("loss", "grad_norm", "step"):
            assert torch.equal(got[key], want[key]), (arch, key, i)
    assert runner.opt_state is opt and opt.step is step_tensor
    assert int(opt.step) == int(ref_opt.step) == STEPS
    got, want = model.state_dict(), ref_model.state_dict()
    assert all(torch.equal(got[n], want[n]) for n in want)
    for moment in ("m", "v"):
        a, b = getattr(opt, moment), getattr(ref_opt, moment)
        assert all(torch.equal(a[n], b[n]) for n in b), (arch, moment)


def test_loop_replays_bitwise_and_restores_the_live_step(monkeypatch):
    """The loop through ``EagerTrainStep`` with host 3 failing after step
    5: the losses after the restore are bitwise the uninterrupted run's
    from the step-4 checkpoint on, as are the final parameters; the
    restore writes the step counter that the step buffers hold, so the
    final count is the run's 8, not 10."""
    runners, loaded = [], []
    make_runner, load = loopmod.EagerTrainStep, loopmod._load_state

    def spy_runner(*args, **kwargs):
        runners.append(make_runner(*args, **kwargs))
        return runners[-1]

    def spy_load(model, opt_state, restored):
        loaded.append((opt_state, int(restored["opt"].step)))
        load(model, opt_state, restored)

    monkeypatch.setattr(loopmod, "EagerTrainStep", spy_runner)
    monkeypatch.setattr(loopmod, "_load_state", spy_load)
    kw = dict(model_cfg=tiny_cfg(), data_cfg=DataConfig(batch=4, seq_len=16),
              opt_cfg=OPT, log=lambda s: None, device="cpu")
    loop = LoopConfig(steps=8, ckpt_every=4, log_every=100,
                      blocks_per_host=4)
    base = train(loop_cfg=loop, **kw)
    failed = train(loop_cfg=loop, fail_at={5: 3}, scheme="ftr", **kw)
    assert len(runners) == 2 and all(type(r) is make_runner for r in runners)
    assert failed.losses[:6] == base.losses[:6]
    assert failed.losses[6:] == base.losses[4:]
    [(opt_state, restored_step)] = loaded
    assert opt_state is runners[1].opt_state is failed.final_state["opt"]
    assert restored_step == 4
    assert int(failed.final_state["opt"].step) == 8
    sd_a = base.final_state["params"].state_dict()
    sd_b = failed.final_state["params"].state_dict()
    assert all(torch.equal(sd_a[n], sd_b[n]) for n in sd_a)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_reads_nothing_on_the_host(arch):
    cfg = get_smoke_config(arch)
    model, opt = fresh(cfg)
    runner = EagerTrainStep(cfg, OPT, model, opt, n_micro=2)
    first, second = batches(cfg, 2)
    runner(first)                   # the static batch is made here
    mode = NoHostReads()
    with mode:
        metrics = runner(second)
    assert mode.ops > 100 and int(metrics["step"]) == 2


def test_train_graph_needs_cuda():
    cfg = get_smoke_config("olmo-1b")
    model, opt = fresh(cfg)
    with pytest.raises(ValueError, match="CUDA"):
        TrainGraph(cfg, OPT, model, opt)
    runner = EagerTrainStep(cfg, OPT, model, opt)
    first, second = batches(cfg, 2)
    runner(first)
    with pytest.raises(ValueError, match="shapes"):
        runner({k: v[:2] for k, v in second.items()})
