"""Faults planted in the program, for showing that ``correct`` comes out
false: each is a context manager that patches the program underneath a
run.  ``FAULTS[loop][name]``; the loops are those of ``perfbench/loops``.

- ``unchanged``: the step or repair returns its state unchanged;
- ``half_batch``: half of each batch left out, the mean taken over the
  rest;
- ``altered``: an answer altered where it is produced (a coded block's
  byte, a plan's time).

No cell spans chips, so no fault leaves an exchange out.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def train_unchanged():
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import OptState, global_norm

    def no_update(cfg, params, grads, state, lr_scale=1.0):
        gnorm = global_norm(list(grads.values()))
        return params, OptState(step=state.step + 1, m=state.m,
                                v=state.v), gnorm
    with mock.patch.object(step_mod, "_apply_updates", no_update):
        yield


@contextlib.contextmanager
def train_half_batch():
    from repro_torch.train import step as step_mod
    split = step_mod._split_microbatches

    def half(batch, n_micro):
        return [{k: v[: max(1, v.shape[0] // 2)] for k, v in mb.items()}
                for mb in split(batch, n_micro)]
    with mock.patch.object(step_mod, "_split_microbatches", half):
        yield


@contextlib.contextmanager
def coded_block_altered(cls_path: str, method: str):
    """The first coded block that ``cls.method`` returns (of its first
    shard, for an encoded group) has every byte XORed with 0x5A."""
    import importlib
    mod_name, cls_name = cls_path.rsplit(".", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    orig = getattr(cls, method)

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        target = out.shards[next(iter(out.shards))] \
            if hasattr(out, "shards") else out
        target.payload[0] ^= 0x5A
        return out
    with mock.patch.object(cls, method, altered):
        yield


@contextlib.contextmanager
def repair_unchanged():
    from repro_torch.storage import simulator
    with mock.patch.object(simulator.RlncSimulator, "execute_plan",
                           lambda self, *a, **kw: None):
        yield


@contextlib.contextmanager
def plan_half_batch():
    import torch
    from repro_torch import core
    orig = core.plan_many

    def half(nets, params, scheme, **kw):
        b = nets.shape[0]
        res = orig(nets[: b - b // 2], params, scheme, **kw)
        for f in ("times", "traffic", "betas", "parents", "lower_bounds"):
            t = getattr(res, f)
            if isinstance(t, torch.Tensor):
                setattr(res, f, torch.cat([t, t])[:b])
        return res
    with mock.patch.object(core, "plan_many", half):
        yield


@contextlib.contextmanager
def plan_altered():
    from repro_torch import core
    orig = core.plan_many

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.times = res.times * (1 + 1e-6)
        return res
    with mock.patch.object(core, "plan_many", altered):
        yield


FAULTS = {
    "train": {
        "unchanged": train_unchanged,
        "half_batch": train_half_batch,
        "altered": lambda: coded_block_altered(
            "repro_torch.ft.erasure.ErasureCoder", "encode"),
    },
    "repair": {
        "unchanged": repair_unchanged,
        "altered": lambda: coded_block_altered(
            "repro_torch.coding.rlnc.RLNC", "regenerate"),
    },
    "plan": {
        "half_batch": plan_half_batch,
        "altered": plan_altered,
    },
}
