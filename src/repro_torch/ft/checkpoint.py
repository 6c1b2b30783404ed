"""Erasure-coded distributed checkpointing with fast heterogeneity-aware
regeneration (the counterpart of ``repro.ft.checkpoint``).

``ECCheckpoint.save`` shards a train-state tree over a recovery group of
hosts; ``on_host_failure`` regenerates the lost shard with the FR/TR/FTR
planner (not a full any-k reconstruction: the regeneration moves about
M/k * d/(d-k+1) blocks instead of M); ``restore`` rebuilds the tree from
any k live hosts.  ``reshard`` re-encodes onto another group.

The checkpoint lives on its coder's device (``ErasureCoder(device=...)``:
``cuda`` unless ``"cpu"`` is named, raising without CUDA): the state's
bytes, every shard and every product stay there, and ``restore`` returns
tensors there.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .erasure import EncodedGroup, ErasureCoder, TreeSpec, bytes_to_tree, \
    tree_to_bytes
from .executor import ExecutionReport, execute_regeneration
from .planner import RecoveryDecision, choose_providers, plan_recovery
from .topology import Fleet


@dataclasses.dataclass
class RecoveryLog:
    decision: RecoveryDecision
    report: ExecutionReport
    wall_s: float


class ECCheckpoint:
    """One checkpointed train state, erasure-coded over fleet hosts."""

    def __init__(self, fleet: Fleet, coder: ErasureCoder,
                 hosts: Sequence[int], seed: int = 0):
        assert len(hosts) == coder.n
        self.fleet = fleet
        self.coder = coder
        self.hosts = list(hosts)
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.group: Optional[EncodedGroup] = None
        self.spec: Optional[TreeSpec] = None
        self.step: int = -1
        self.recoveries: List[RecoveryLog] = []

    @property
    def device(self) -> torch.device:
        return self.coder.device

    # -- save / restore ------------------------------------------------------

    def save(self, state: Any, step: int) -> None:
        buf, self.spec = tree_to_bytes(state, self.device, blocks=self.coder.M)
        self.group = self.coder.encode(buf, self.hosts,
                                       payload_bytes=self.spec.total_bytes)
        self.step = step

    def restore(self, from_hosts: Optional[Sequence[int]] = None) -> Any:
        assert self.group is not None and self.spec is not None
        buf = self.coder.reconstruct(self.group, from_hosts)
        return bytes_to_tree(buf, self.spec)

    # -- failure handling ------------------------------------------------------

    def on_host_failure(self, failed: int, replacement: Optional[int] = None,
                        scheme: str = "auto",
                        block_mb: Optional[float] = None) -> RecoveryLog:
        """Regenerate the failed host's shard onto ``replacement`` (defaults
        to reusing the host id, i.e. the restarted machine).  ``wall_s``
        ends when the regenerated shard is on the device."""
        assert self.group is not None
        assert failed in self.group.shards, f"host {failed} holds no shard"
        replacement = failed if replacement is None else replacement
        survivors = [h for h in self.group.shards if h != failed]
        providers = choose_providers(self.fleet, survivors, replacement,
                                     self.coder.d, rng=self.rng)
        if block_mb is None:
            block_mb = max(self.group.block_bytes / 1e6, 1e-6)
        t0 = time.perf_counter()
        decision = plan_recovery(self.fleet, self.group.params, replacement,
                                 providers, block_mb=block_mb, scheme=scheme,
                                 rng=self.rng)
        del self.group.shards[failed]
        report = execute_regeneration(self.group, decision.plan,
                                      decision.overlay, replacement,
                                      providers, rng=self.np_rng,
                                      rl=self.coder.rl)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if replacement != failed:
            self.hosts = [replacement if h == failed else h
                          for h in self.hosts]
        log = RecoveryLog(decision=decision, report=report,
                          wall_s=time.perf_counter() - t0)
        self.recoveries.append(log)
        return log

    # -- elastic resharding -----------------------------------------------------

    def reshard(self, new_coder: ErasureCoder, new_hosts: Sequence[int],
                ) -> "ECCheckpoint":
        """Elastic scale up/down: reconstruct from any k, re-encode onto a
        new group (possibly different n/k/d, host set and device)."""
        assert self.group is not None
        buf = self.coder.reconstruct(self.group)
        out = ECCheckpoint(self.fleet, new_coder, new_hosts,
                           seed=self.rng.randint(0, 2 ** 31))
        out.spec = self.spec
        out.group = new_coder.encode(buf, new_hosts)
        out.step = self.step
        return out
