"""Training loop with erasure-coded checkpointing and failure recovery (the
counterpart of ``repro.train.loop``).

The loop demonstrates the full fault-tolerance story end to end:
  * every ``ckpt_every`` steps the training state is erasure-coded over a
    recovery group of hosts (``repro_torch.ft``), on the device: its bytes,
    shards and every GF(2^8) product (the kernel on the card);
  * an injected host failure triggers FR/TR/FTR regeneration of the lost
    shard (heterogeneous-link-aware, the paper's contribution), then the
    training state is restored from the group and training resumes;
  * the data pipeline is a pure function of the step, so the replayed steps
    repeat the uninterrupted run's (tested).

On the card the loop runs one ``TrainGraph`` (the step captured as a CUDA
graph, the reference's ``jax.jit``): the first step runs eagerly, as the
capture's warm-up, and every later one replays the graph.  The graph is
released before a save or a regeneration and restore, which need its
memory, and captured again at the next step.  On the CPU the loop runs ``EagerTrainStep``, the
same buffers and call, eagerly.

The checkpointed state is ``{"params": model.state_dict(), "opt":
OptState, "step": np.int32}``: the port's own layout (one tensor per layer
in the ``state_dict``'s order, moments keyed by parameter name), not the
reference's stacked one, so its bytes differ from the reference's.  A
restore copies the saved leaves into the live parameters and moments and
drops the restored tree (its leaves are views of one decoded buffer).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ft import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
from ..ft.erasure import tree_flatten
from ..models import init_params
from ..models.config import ModelConfig
from .data import DataConfig, SyntheticLM
from .graph import EagerTrainStep, TrainGraph
from .optimizer import OptimizerConfig, init_opt


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    n_micro: int = 1
    log_every: int = 10
    # recovery group
    ec_n: int = 8
    ec_k: int = 4
    ec_d: int = 6
    blocks_per_host: int = 16
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    final_state: Any
    recoveries: List[Any]
    steps_run: int


@torch.no_grad()
def _load_state(model, opt_state, restored) -> None:
    """Copy the restored parameters and moments into the live tensors."""
    live, live_def = tree_flatten({"params": model.state_dict(),
                                   "opt": opt_state})
    saved, saved_def = tree_flatten({"params": restored["params"],
                                     "opt": restored["opt"]})
    if live_def != saved_def:
        raise ValueError("the restored state does not match the live one")
    for dst, src in zip(live, saved):
        dst.copy_(src)


def train(model_cfg: ModelConfig, data_cfg: DataConfig,
          opt_cfg: OptimizerConfig, loop_cfg: LoopConfig,
          fail_at: Optional[Dict[int, int]] = None,
          scheme: str = "auto",
          log: Callable[[str], None] = print,
          device: DeviceLike = None) -> TrainResult:
    """Train on ``device`` (``cuda`` unless ``"cpu"`` is named; raises
    without CUDA).  ``fail_at``: {step: host_id} failures injected *after*
    that step; each fires once (the restore rewinds the step counter past
    it)."""
    dev = resolve_device(device)
    fail_at = dict(fail_at or {})
    model = init_params(model_cfg, loop_cfg.seed, device=dev)
    opt_state = init_opt(opt_cfg, model, device=dev)
    data = SyntheticLM(data_cfg, model_cfg, device=dev)
    runner = (TrainGraph if dev.type == "cuda" else EagerTrainStep)(
        model_cfg, opt_cfg, model, opt_state, n_micro=loop_cfg.n_micro)

    fleet = Fleet(FleetConfig(), seed=loop_cfg.seed)
    coder = ErasureCoder(n=loop_cfg.ec_n, k=loop_cfg.ec_k, d=loop_cfg.ec_d,
                         blocks_per_host=loop_cfg.blocks_per_host,
                         seed=loop_cfg.seed, device=dev)
    ckpt = ECCheckpoint(fleet, coder, hosts=list(range(loop_cfg.ec_n)),
                        seed=loop_cfg.seed)

    losses: List[float] = []
    step = 0
    while step < loop_cfg.steps:
        t0 = time.perf_counter()
        metrics = runner(data.batch_at(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % loop_cfg.log_every == 0:
            parts = "".join(f"{k} {float(metrics[k]):.4f} " for k in
                            ("lb_loss", "z_loss") if k in metrics)
            log(f"step {step:4d} loss {loss:.4f} {parts}"
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"dt {time.perf_counter() - t0:.2f}s")
        del metrics
        if (step + 1) % loop_cfg.ckpt_every == 0:
            runner.release()
            ckpt.save({"params": model.state_dict(), "opt": opt_state,
                       "step": np.int32(step + 1)}, step + 1)
            log(f"step {step:4d} checkpoint saved "
                f"(EC n={coder.n} k={coder.k} d={coder.d})")
        if step in fail_at:
            host = fail_at.pop(step)
            log(f"step {step:4d} !! host {host} failed")
            if ckpt.group is not None:
                runner.release()
                rec = ckpt.on_host_failure(host, scheme=scheme)
                log(f"           regen scheme={rec.decision.plan.scheme} "
                    f"predicted={rec.decision.predicted_s:.3f}s "
                    f"(alternatives: "
                    + " ".join(f"{k}={v:.3f}s"
                               for k, v in rec.decision.alternatives.items())
                    + ")")
                restored = ckpt.restore()
                _load_state(model, opt_state, restored)
                step = int(restored["step"]) - 1
                del restored
                log(f"           restored from EC checkpoint at step "
                    f"{step + 1}; replaying")
        step += 1

    return TrainResult(losses=losses,
                       final_state={"params": model, "opt": opt_state},
                       recoveries=list(ckpt.recoveries),
                       steps_run=len(losses))
