"""Link-capacity models for overlay networks and whole clusters.

``uniform`` reproduces the paper's evaluation setting (PlanetLab-derived
U[10,120] Mbps, Section VI) for a single repair's (d+1)-node overlay.

``uniform_matrix`` is the cluster-scale analogue: it samples the full n x n
directed capacity matrix once, so concurrent repairs planned at different
times see the *same* physical link.  Both draw exactly what their
counterparts in ``repro.storage.capacities`` draw.
"""
from __future__ import annotations

import random
from typing import Callable, List

import numpy as np

from ..core.params import OverlayNetwork

CapSampler = Callable[[random.Random, int], OverlayNetwork]

# (numpy Generator, cluster size n) -> (n, n) directed capacities, diag 0
ClusterCapSampler = Callable[[np.random.Generator, int], np.ndarray]


def uniform_matrix(lo: float = 10.0, hi: float = 120.0) -> ClusterCapSampler:
    """All n*(n-1) directed cluster links i.i.d. U[lo, hi] (blocks/sec)."""

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        caps = rng.uniform(lo, hi, size=(n, n))
        np.fill_diagonal(caps, 0.0)
        return caps

    return sample


def uniform(lo: float = 10.0, hi: float = 120.0) -> CapSampler:
    """All directed links i.i.d. U[lo, hi] (Mbps) — the paper's default."""

    def sample(rng: random.Random, d: int) -> OverlayNetwork:
        cap: List[List[float]] = [[0.0] * (d + 1) for _ in range(d + 1)]
        for u in range(d + 1):
            for v in range(d + 1):
                if u != v:
                    cap[u][v] = rng.uniform(lo, hi)
        return OverlayNetwork(cap)

    return sample


# the five distributions of Fig. 7
FIG7_DISTRIBUTIONS = {
    "U1[0.3,120]": uniform(0.3, 120.0),
    "U2[3,120]": uniform(3.0, 120.0),
    "U3[30,120]": uniform(30.0, 120.0),
    "U4[60,120]": uniform(60.0, 120.0),
    "U5[90,120]": uniform(90.0, 120.0),
}
