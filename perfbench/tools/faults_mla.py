"""Faults planted under the ``train_mla`` loop: the train faults of
``faults.py``, ``faults_moe.py``'s router of capacity 1.25, and two of
DeepSeek-V2's own parts left out of the program: YaRN's mscale^2 in the
softmax scale (the scores scaled by head_dim^-1/2 alone) and the shared
experts (the MoE layers' output the routed share's alone)."""
from __future__ import annotations

import contextlib
from unittest import mock

from perfbench.tools.faults import train_half_batch, train_unchanged
from perfbench.tools.faults_moe import capacity_drop


@contextlib.contextmanager
def scale_without_mscale():
    """``MLAShareConfig.softmax_scale`` without YaRN's mscale^2."""
    from repro_torch.models import MLAShareConfig
    with mock.patch.object(MLAShareConfig, "softmax_scale", property(
            lambda self: self.head_dim ** -0.5)):
        yield


@contextlib.contextmanager
def shared_experts_left_out():
    """``SharedMoEShare`` adds the shared experts' output times zero to the
    routed share (so their weights still get a gradient, of zeros)."""
    from repro_torch.models.moe import SharedMoEShare
    with mock.patch.object(SharedMoEShare, "add_shared",
                           lambda self, x, y: y + 0.0 * self.shared(x)
                           .float()):
        yield


FAULTS_MLA = {"unchanged": train_unchanged, "half_batch": train_half_batch,
              "capacity": capacity_drop, "no_mscale": scale_without_mscale,
              "no_shared": shared_experts_left_out}
