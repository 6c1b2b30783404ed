"""The training loop's compiled step: the counterpart of the reference's
``jax.jit`` over ``make_train_step`` (``repro.train.loop``), as one CUDA
graph captured once and replayed at every step after the first.

``make_train_step(cfg, opt_cfg, n_micro)`` reads nothing on the host, and
every shape in it is fixed by the batch's, so one capture serves every
step of a run, as the reference's one executable does.  The capture holds
the whole step: the microbatches' forward, remat and backward, the
``grad_dtype`` accumulation, the optimizer and the metrics.  A graph owns
its static buffers: the batch (filled by ``copy_`` at each step), the live
model and ``OptState`` (updated in place, the new step count written back
into the live ``OptState.step``, which a checkpoint saves and a restore
writes) and the metrics, which the next replay overwrites.

:class:`EagerTrainStep` holds the same buffers and makes the same call
without capturing it: the loop's path on the CPU, and the one the tests
name.  :class:`TrainGraph` runs on CUDA only: its first call is the
eager step, the warm-up that a capture needs; every later one replays the
graph.  A failed capture raises: no path falls back to the eager step.
Its calls are the spans ``train.eager``, ``train.capture`` and
``train.replay``, and ``release()`` the span ``train.release``
(``obs.spans``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..obs import spans
from .optimizer import OptimizerConfig, OptState
from .step import make_train_step


class EagerTrainStep:
    """``make_train_step(cfg, opt_cfg, n_micro)`` over the live ``model``
    and ``opt_state`` and a static batch, run eagerly.  ``__call__(batch)``
    copies the batch into the static one (made at the first call; later
    batches must have its keys and shapes), runs the step and returns its
    metrics (``loss``, ``grad_norm``, ``step``: 0-d tensors on the
    device).  The parameters and moments are updated in place and the step
    count is written into ``opt_state.step``, so the ``model`` and
    ``opt_state`` given stay the live state."""

    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig, model,
                 opt_state: OptState, n_micro: int = 1):
        self.step_fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
        self.model, self.opt_state = model, opt_state
        self.batch: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, torch.Tensor] = {}

    def _load(self, batch: Dict[str, torch.Tensor]) -> None:
        if not self.batch:
            self.batch = {k: v.clone() for k, v in batch.items()}
            return
        if batch.keys() != self.batch.keys() or any(
                batch[k].shape != v.shape for k, v in self.batch.items()):
            raise ValueError("a batch with other keys or shapes than the "
                             "first one")
        for k, v in self.batch.items():
            v.copy_(batch[k])

    def _step(self) -> Dict[str, torch.Tensor]:
        _, state, metrics = self.step_fn(self.model, self.opt_state,
                                         self.batch)
        self.opt_state.step.copy_(state.step)
        return metrics

    def release(self) -> None:
        """Free what the step holds between calls (nothing, eagerly)."""

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        self._load(batch)
        self.metrics = self._step()
        return self.metrics


class TrainGraph(EagerTrainStep):
    """:class:`EagerTrainStep`'s step captured into a
    ``torch.cuda.CUDAGraph`` with its own memory pool and replayed.

    The first call runs the step eagerly on a side stream: it is the run's
    real first step and the warm-up that a capture needs (the libraries'
    lazy set-up stays out of the graph), so no state is advanced twice.
    Every later call replays the graph, captured at the first of them
    (after the batch is copied in); the metrics returned are the graph's
    static outputs.  ``release()`` drops the graph, whose pool keeps the
    step's transient memory between replays (a checkpoint's save or
    restore needs the room); the next call captures the step again."""

    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig, model,
                 opt_state: OptState, n_micro: int = 1):
        self.device = next(model.parameters()).device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{self.device}")
        super().__init__(cfg, opt_cfg, model, opt_state, n_micro)
        self.graph = None
        self.warm = False

    def _warm_step(self) -> Dict[str, torch.Tensor]:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self._step()
        main.wait_stream(side)
        self.warm = True
        return metrics

    def _capture(self) -> None:
        with spans.span("train.capture"), torch.cuda.device(self.device):
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.metrics = self._step()

    def release(self) -> None:
        """Drop the graph and its static metrics, and free its pool.  The
        pool is freed here, not left to the allocator, which frees it only
        when an allocation fails: at olmo-1b on an H100 a save then took up
        to 6.9 s, against 0.6-1.1 s after the explicit free."""
        with spans.span("train.release"):
            self.graph = None
            self.metrics = {}
            torch.cuda.empty_cache()

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        self._load(batch)
        if not self.warm:
            with spans.span("train.eager"):
                self.metrics = self._warm_step()
            return self.metrics
        if self.graph is None:
            self._capture()
        with spans.span("train.replay"):
            self.graph.replay()
        return self.metrics
