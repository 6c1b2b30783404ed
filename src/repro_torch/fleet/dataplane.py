"""Coded data plane for the fleet simulator.

With ``Scenario(dataplane=True)`` the fleet stops treating reads and
repairs as phantom fluids and moves *data*:

* a degraded read is ``fanin`` fragment transfers (``params.alpha``
  blocks each, ``dataplane_block_bytes`` per block) whose completion
  time emerges from fair-share link contention — exactly the same
  fluid arithmetic repairs use, through the same ``LinkShareModel`` —
  instead of the fixed ``Scenario.read_duration``;
* every completed repair replays its plan on a real RLNC-coded store
  (``repro_torch.storage.simulator.RlncSimulator.execute_plan``: provider
  encode, interior relay, newcomer regenerate over GF(2^8)), held on the
  simulator's device, so the regenerated node holds actual coded blocks
  that can be decode-verified with ``RLNC.can_reconstruct``.  On the card
  every product of the store is a launch of the GF(2^8) matmul kernel
  (``repro_torch.kernels.ops.gf_matmul``);
* bytes on the wire are accounted per link, split into repair vs read
  traffic, and exported through the flight recorder and the
  ``dataplane_*`` rows of ``BENCH_fleet.json``.

Fragment sizing
---------------
The cluster's nominal code stores ``alpha = M/k`` blocks per node; a
degraded read reconstructs the object from ``fanin`` fragments (default
``fanin = params.k``) of ``alpha`` blocks each.  Flows are expressed in
the same block units as link capacities (blocks/sec), so a solo read
over a capacity-``c`` link takes exactly ``alpha / c`` seconds; bytes
are blocks times ``dataplane_block_bytes``.

The coded store is a *miniature* of the cluster code: same ``(n, k,
d)``, but ``M`` scaled down to ``dataplane_blocks`` (default ``2k``)
so GF arithmetic per repair stays cheap.  Completed plans are replayed
with betas/flows ceil-scaled by ``alpha_mini / alpha`` — the Theorem-1
cut constraints are linear in ``beta``, so exact scaling keeps them
satisfied and ``ceil`` only adds slack.  The store draws from its own
rng streams (seeded from the fleet seed), so producing blocks never
perturbs fleet randomness and the traced-equals-untraced invariant
holds unchanged.

Trace-driven reads
------------------
``ReadTrace`` is an open-loop arrival process: either a Poisson
``rate`` (drawn from the fleet's dedicated ``"data"`` rng stream) or a
JSONL ``path`` of ``{"t": <seconds>}`` lines replayed lazily one line
at a time — O(1) memory, so traces of millions of arrivals stream
fine.  ``generate_trace`` writes such a file in vectorized chunks.
Unlike the legacy closed-loop ``read_rate`` (which only fires while a
slot is down), trace arrivals are *served whenever >= fanin + 1
healthy nodes exist* — degraded or not — and are **dropped and
counted** (``reads_dropped``) otherwise; see ``Scenario`` validation.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding import GF8
from ..core import CodeParams
from ..device import DeviceLike, resolve_device
from ..kernels.ops import gf_matmul
from ..storage.simulator import RlncSimulator
from .sharing import Link, plan_links

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from .metrics import FleetMetrics
    from .scenario import Scenario
    from .sharing import ActiveRepair, LinkShareModel

__all__ = ["DataPlane", "ReadFlow", "ReadTrace", "generate_trace"]

# mixed into the fleet seed for the coded store's own rng streams
_STORE_SALT = 0xDA7A


def _host_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``GF8.matmul`` (log/antilog tables, host NumPy) on CPU tensors."""
    return torch.from_numpy(GF8.matmul(a.numpy(), b.numpy()))


# ---------------------------------------------------------------------------
# Open-loop read arrival traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReadTrace:
    """Open-loop read workload: a JSONL file of arrivals or a Poisson rate.

    Exactly one of ``path``/``rate`` must be set.  ``path`` points at a
    JSONL file with one ``{"t": <arrival seconds>}`` object per line
    (nondecreasing ``t``); it is replayed lazily line by line, so trace
    files with millions of arrivals never materialize in memory.
    ``rate`` draws exponential gaps from the simulator's dedicated
    ``"data"`` rng stream at generation time.
    """

    path: Optional[str] = None
    rate: float = 0.0

    def __post_init__(self) -> None:
        if (self.path is None) == (self.rate <= 0.0):
            raise ValueError(
                "ReadTrace needs exactly one of path= or rate= > 0, got "
                f"path={self.path!r} rate={self.rate!r}")

    def arrivals(self, rng: np.random.Generator,
                 horizon: float) -> Iterator[float]:
        """Yield arrival times in ``[0, horizon]``, lazily."""
        if self.path is not None:
            return self._replay(horizon)
        return self._poisson(rng, horizon)

    def _replay(self, horizon: float) -> Iterator[float]:
        with open(self.path) as f:  # buffered: O(1) memory chunked replay
            for line in f:
                line = line.strip()
                if not line:
                    continue
                t = float(json.loads(line)["t"])
                if t > horizon:
                    return
                yield t

    def _poisson(self, rng: np.random.Generator,
                 horizon: float) -> Iterator[float]:
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t > horizon:
                return
            yield t


def generate_trace(path: str, rate: float, duration: float, seed: int = 0,
                   chunk: int = 65536) -> int:
    """Write a Poisson arrival trace to ``path``; return the arrival count.

    Gaps are drawn in vectorized chunks and streamed straight to disk,
    so ``rate * duration`` in the millions is fine.  The chunk size does
    not change the output bit-for-bit: draws are sequential, and seeding
    each chunk's accumulate with the running time keeps the float
    recurrence ``t_i = t_{i-1} + gap_i`` identical across any chunking
    (``base + cumsum(chunk)`` would round differently at chunk seams).
    """
    if rate <= 0.0 or duration <= 0.0:
        raise ValueError(f"need rate > 0 and duration > 0, got "
                         f"{rate!r}/{duration!r}")
    rng = np.random.default_rng(seed)
    count, t = 0, 0.0
    with open(path, "w") as f:
        while t <= duration:
            gaps = rng.exponential(1.0 / rate, size=chunk)
            ts = np.add.accumulate(np.concatenate(((t,), gaps)))[1:]
            t = float(ts[-1])
            keep = ts[ts <= duration]
            f.write("".join(f'{{"t": {float(x)!r}}}\n' for x in keep))
            count += int(keep.size)
            if keep.size < ts.size:
                break
    return count


# ---------------------------------------------------------------------------
# In-flight read transfers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(slots=True)
class ReadFlow:
    """A degraded read in flight: ``fanin`` fragment transfers.

    Shares the fluid-progress representation of ``ActiveRepair``
    (``remaining`` fraction of the lockstep schedule, ``nominal``
    solo-time refreshed by ``LinkShareModel.recompute``) so the share
    engine treats reads and repairs as one population of flows.
    """

    rdid: int
    dst: int
    sources: List[int]
    links: List[Tuple[Link, float]]   # [((src, dst), fragment_blocks)]
    arrival: float
    bytes_total: float
    remaining: float = 1.0
    nominal: float = math.inf

    @property
    def node(self) -> int:
        """Check-mode oracle messages name flows by node; use the dst."""
        return self.dst


# ---------------------------------------------------------------------------
# The data plane proper
# ---------------------------------------------------------------------------

class DataPlane:
    """Coded store + read flows + bytes-on-the-wire ledgers for one fleet.

    Owned by ``FleetSimulator`` when ``Scenario(dataplane=True)``; all
    rng here (the store's encode/relay/regenerate draws) lives in
    streams derived from ``seed`` + :data:`_STORE_SALT`, disjoint from
    the fleet's own streams.  The store lives on ``device`` (the
    simulator's: the card unless the CPU was named).
    """

    def __init__(self, scenario: "Scenario", params, shares: "LinkShareModel",
                 metrics: "FleetMetrics", seed: int, recorder=None,
                 device: DeviceLike = None):
        self.scenario = scenario
        self.params = params
        self.shares = shares
        self.metrics = metrics
        self.recorder = recorder
        self.fanin = scenario.read_fanin or params.k
        self.fragment_blocks = float(params.alpha)
        self.block_bytes = float(scenario.dataplane_block_bytes)
        self.verify = scenario.dataplane_verify

        m_c = scenario.dataplane_blocks or 2 * params.k
        if m_c % params.k != 0:
            raise ValueError(
                f"dataplane_blocks={m_c} must be divisible by k={params.k} "
                f"(the mini-code needs integral alpha = M/k)")
        self.mini = CodeParams.msr(n=scenario.num_nodes, k=params.k,
                                   d=params.d, M=float(m_c))
        self.scale = self.mini.alpha / params.alpha
        device = resolve_device(device)
        self.store = RlncSimulator(
            self.mini, block_bytes=scenario.dataplane_payload_bytes,
            seed=(seed * 1_000_003 + _STORE_SALT) % (1 << 31),
            matmul=self._resolve_matmul(scenario.dataplane_matmul, device),
            device=device)

        self.reads: List[ReadFlow] = []
        self._rd_seq = 0
        self.repair_link_bytes: Dict[Link, float] = {}
        self.read_link_bytes: Dict[Link, float] = {}

    @staticmethod
    def _resolve_matmul(mode: str, device: torch.device):
        """GF matmul backend for the coded store on ``device``.

        ``"kernel"`` and ``"auto"`` are ``repro_torch.kernels.ops.gf_matmul``
        on the store's device: the Hopper kernel on the card, the plain
        PyTorch version on CPU tensors, never one for the other.
        ``"numpy"`` is the field's log/antilog tables (:func:`_host_matmul`)
        on a CPU store, taken only when the caller names it; a store on the
        card refuses it rather than copy its blocks to the host.
        """
        if mode != "numpy":
            return gf_matmul
        if device.type != "cpu":
            raise ValueError(
                f"dataplane_matmul='numpy' runs on a CPU store only; the "
                f"store on {device} multiplies with the kernel "
                f"('kernel' or 'auto')")
        return _host_matmul

    # -- degraded reads as fragment transfers -------------------------------

    def start_read(self, now: float, dst: int,
                   sources: Sequence[int]) -> ReadFlow:
        fb = self.fragment_blocks
        links = [((int(s), int(dst)), fb) for s in sources]
        fl = ReadFlow(rdid=self._rd_seq, dst=int(dst),
                      sources=[int(s) for s in sources], links=links,
                      arrival=now,
                      bytes_total=len(links) * fb * self.block_bytes)
        self._rd_seq += 1
        self.reads.append(fl)
        self.shares.acquire(links, fl)
        if self.recorder is not None:
            self.recorder.emit(now, "read_queued", rdid=fl.rdid, dst=fl.dst,
                               sources=fl.sources, bytes=fl.bytes_total)
        return fl

    def advance_reads(self, dt: float) -> None:
        """Mirror of the repair progress update in ``FleetSimulator._advance``."""
        if dt == 0.0:
            for fl in self.reads:
                if fl.nominal == 0.0:
                    fl.remaining = 0.0
            return
        for fl in self.reads:
            nom = fl.nominal
            if nom > 0.0 and nom != math.inf:
                rem = fl.remaining - dt / nom
                fl.remaining = rem if rem > 0.0 else 0.0
            elif nom == 0.0:
                fl.remaining = 0.0

    def next_read_completion(self, now: float) -> Tuple[float, int]:
        best_t, best_i = math.inf, -1
        for i, fl in enumerate(self.reads):
            rem = fl.remaining
            t = now + rem * fl.nominal if rem > 0.0 else now
            if t < best_t:
                best_t, best_i = t, i
        return best_t, best_i

    def complete_read(self, i: int, now: float) -> ReadFlow:
        fl = self.reads.pop(i)
        self.shares.release(fl.links, fl)
        for link, f in fl.links:
            self.read_link_bytes[link] = (
                self.read_link_bytes.get(link, 0.0) + f * self.block_bytes)
        self.metrics.on_read_complete(now - fl.arrival, fl.bytes_total)
        if self.recorder is not None:
            self.recorder.emit(now, "read_complete", rdid=fl.rdid,
                               dst=fl.dst, latency=now - fl.arrival,
                               bytes=fl.bytes_total)
        return fl

    def teardown_node(self, node: int, now: float) -> None:
        """A node failed: kill reads it serves or sources.

        Partially transferred fragment bytes did cross the wire and
        stay in the per-link read ledger (and ``read_bytes``); the read
        itself counts as torn down, not completed.
        """
        dead = [i for i, fl in enumerate(self.reads)
                if fl.dst == node or node in fl.sources]
        for i in reversed(dead):
            fl = self.reads.pop(i)
            self.shares.release(fl.links, fl)
            done = 1.0 - fl.remaining
            partial = 0.0
            if done > 0.0:
                for link, f in fl.links:
                    b = done * f * self.block_bytes
                    self.read_link_bytes[link] = (
                        self.read_link_bytes.get(link, 0.0) + b)
                    partial += b
            self.metrics.on_read_teardown(partial)
            if self.recorder is not None:
                self.recorder.emit(now, "read_abort", rdid=fl.rdid,
                                   dst=fl.dst, node=node, bytes=partial)

    # -- repair traffic: wire bytes + coded-block production ----------------

    def account_repair_wire(self, r: "ActiveRepair", done: float) -> None:
        """Bank ``done`` of repair ``r``'s current segment into the ledger.

        Must run *before* the segment's ``shares.release``/``rebase`` —
        those destroy the links/progress the accounting reads.  ``done``
        is the delivered fraction of the lockstep schedule; each link
        carried ``done * residual_flow`` blocks.
        """
        if done <= 0.0:
            return
        bb = self.block_bytes
        total = 0.0
        for link, f in r.links:
            b = done * f * bb
            self.repair_link_bytes[link] = (
                self.repair_link_bytes.get(link, 0.0) + b)
            total += b
        self.metrics.on_repair_bytes(total)

    def _scaled_plan(self, plan):
        """The plan re-expressed in mini-code block units.

        Betas/flows scale exactly by ``alpha_mini / alpha`` (Theorem-1
        constraints are linear, so feasibility is preserved); the ceil
        at execution then only ever adds blocks.
        """
        if self.scale == 1.0:
            return plan
        s = self.scale
        return dataclasses.replace(
            plan, betas=[b * s for b in plan.betas],
            flows={e: f * s for e, f in plan.flows.items()})

    def on_repair_complete(self, r: "ActiveRepair", now: float) -> None:
        """Produce the completed repair's coded blocks on the store."""
        self.store.execute_plan(self._scaled_plan(r.plan), failed=r.node,
                                provider_ids=list(r.ids[1:]))
        if self.recorder is not None:
            for link, f in plan_links(r.plan, r.ids):
                self.recorder.emit(now, "repair_block", rid=r.rid,
                                   producer=link[0], dst=link[1],
                                   bytes=f * self.block_bytes)
        if self.verify:
            self.metrics.on_decode_check(self._decode_check(r.node))

    def _decode_check(self, node: int) -> bool:
        """Can ``k`` nodes including the regenerated one still decode?

        A single k-subset of an MSR-sized RLNC store stacks exactly M
        coding vectors, so any one subset is singular with probability
        ~1/|GF| per draw — the whp caveat the paper's Fig. 10 measures as
        reconstruction *probability*.  Data loss means NO subset decodes,
        so the check slides the (k-1)-window of companion nodes over a few
        positions and fails only when every window does.  Node choice is
        deterministic (sorted other ids), so verification consumes no
        randomness.
        """
        k1 = self.params.k - 1
        others = [i for i in sorted(self.store.nodes) if i != node]
        tries = min(4, max(1, len(others) - k1 + 1))
        for off in range(tries):
            combo = [self.store.nodes[i]
                     for i in [node] + others[off:off + k1]]
            if self.store.rl.can_reconstruct(combo, int(self.mini.M)):
                return True
        return False

    # -- export -------------------------------------------------------------

    @property
    def repair_bytes(self) -> float:
        return sum(self.repair_link_bytes.values())

    @property
    def read_bytes(self) -> float:
        return sum(self.read_link_bytes.values())

    def link_bytes(self) -> Dict[str, Dict[str, float]]:
        """Per-link ``{"src->dst": {"repair_bytes", "read_bytes"}}``."""
        out: Dict[str, Dict[str, float]] = {}
        for link, b in self.repair_link_bytes.items():
            cell = out.setdefault(f"{link[0]}->{link[1]}",
                                  {"repair_bytes": 0.0, "read_bytes": 0.0})
            cell["repair_bytes"] += b
        for link, b in self.read_link_bytes.items():
            cell = out.setdefault(f"{link[0]}->{link[1]}",
                                  {"repair_bytes": 0.0, "read_bytes": 0.0})
            cell["read_bytes"] += b
        return out

    def top_links(self, k: int = 10) -> List[Tuple[str, Dict[str, float]]]:
        """Top-``k`` links by total bytes on the wire (ties by name)."""
        stats = self.link_bytes()
        return sorted(
            stats.items(),
            key=lambda kv: (-(kv[1]["repair_bytes"] + kv[1]["read_bytes"]),
                            kv[0]))[:k]

    def snapshot(self) -> Dict[str, object]:
        """Strict-JSON summary for the flight-recorder header meta."""
        return {
            "block_bytes": self.block_bytes,
            "fragment_blocks": self.fragment_blocks,
            "fanin": self.fanin,
            "mini_blocks": int(self.mini.M),
            "repair_bytes": self.repair_bytes,
            "read_bytes": self.read_bytes,
            "links": self.link_bytes(),
        }
