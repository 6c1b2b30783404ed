"""TPU-fleet network topology for recovery planning.

The paper's overlays are generic (PlanetLab U[10,120] Mbps); a TPU fleet is
*tiered*: hosts inside a pod see fast links (ICI/within-cluster fabric),
hosts in different pods talk over shared DCN.  Background traffic (other
jobs, data ingest, checkpoint fan-in) modulates available bandwidth per
link — the heterogeneity regime where FR/TR/FTR matter.

``snapshot_overlay`` samples the *currently available* end-to-end bandwidth
between a newcomer host and its d providers, which is exactly the overlay
G(V, E) the planners consume.  Stragglers are modelled as hosts whose
outgoing available bandwidth is scaled down persistently.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

from ..core import OverlayNetwork


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    num_pods: int = 2
    hosts_per_pod: int = 64
    # effective host-to-host bandwidths in GB/s (NIC/fabric level, not ICI
    # chip links): same-pod fast tier, cross-pod DCN tier
    intra_pod_gbps: float = 25.0
    inter_pod_gbps: float = 6.25
    # available-bandwidth multiplier ~ U[lo, hi] per directed link per
    # snapshot (background traffic)
    load_lo: float = 0.15
    load_hi: float = 1.0
    # persistent per-host straggler multiplier (1.0 = healthy)
    straggler_fraction: float = 0.05
    straggler_slowdown: float = 0.1


class Fleet:
    """Host inventory with pod placement and straggler state."""

    def __init__(self, cfg: FleetConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = random.Random(seed)
        self.num_hosts = cfg.num_pods * cfg.hosts_per_pod
        self.straggle: Dict[int, float] = {}
        for h in range(self.num_hosts):
            if self.rng.random() < cfg.straggler_fraction:
                self.straggle[h] = cfg.straggler_slowdown

    def pod_of(self, host: int) -> int:
        return host // self.cfg.hosts_per_pod

    def mark_straggler(self, host: int, slowdown: float) -> None:
        self.straggle[host] = slowdown

    def heal(self, host: int) -> None:
        self.straggle.pop(host, None)

    def base_bw(self, u: int, v: int) -> float:
        c = (self.cfg.intra_pod_gbps if self.pod_of(u) == self.pod_of(v)
             else self.cfg.inter_pod_gbps)
        return c * self.straggle.get(u, 1.0)

    def capacity_matrix(self, hosts: Sequence[int], block_mb: float = 1.0,
                        rng=None) -> List[List[float]]:
        """Available-bandwidth snapshot among ``hosts`` in blocks/sec.

        Entry [i][j] is the current host[i] -> host[j] bandwidth: the tiered
        base rate times a per-link background-load draw.  ``rng`` may be a
        ``random.Random`` or a ``numpy.random.Generator`` (both expose
        ``uniform(lo, hi)``); the fleet simulator passes the latter.  This
        is the sampler both ``snapshot_overlay`` (single repair) and
        ``repro_torch.fleet``'s tiered scenario (whole cluster) are built on.
        """
        rng = rng if rng is not None else self.rng
        m = len(hosts)
        cap = [[0.0] * m for _ in range(m)]
        for i, u in enumerate(hosts):
            for j, v in enumerate(hosts):
                if i == j:
                    continue
                avail = self.base_bw(u, v) * float(
                    rng.uniform(self.cfg.load_lo, self.cfg.load_hi))
                cap[i][j] = avail * 1000.0 / block_mb   # GB/s -> MB-blocks/s
        return cap

    def snapshot_overlay(self, newcomer: int, providers: Sequence[int],
                         block_mb: float = 1.0,
                         rng: Optional[random.Random] = None,
                         ) -> OverlayNetwork:
        """Overlay in blocks/sec for a repair: node 0 = newcomer, 1..d =
        providers.  ``block_mb`` converts GB/s into block units."""
        ids = [newcomer] + list(providers)
        return OverlayNetwork(self.capacity_matrix(ids, block_mb, rng))
