"""Training substrate: optimizer, step functions, loop, data pipeline (the
counterpart of ``repro.train``)."""
from .optimizer import AdamWConfig, OptimizerConfig, OptState, init_opt, \
    apply_updates, global_norm
from .step import make_decode_step, make_prefill_step, make_train_step
from .data import DataConfig, SyntheticLM
from .loop import LoopConfig, TrainResult, train

__all__ = ["AdamWConfig", "OptimizerConfig", "OptState", "init_opt",
           "apply_updates", "global_norm", "make_decode_step",
           "make_prefill_step", "make_train_step", "DataConfig",
           "SyntheticLM", "LoopConfig", "TrainResult", "train"]
