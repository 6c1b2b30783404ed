"""Generalized information flow graphs and MDS verification (Sections II, IV).

Host code, a copy of ``repro.core.infoflow``.

Builds the information flow graph of a *repair history* — the initial n
storage nodes plus a sequence of (tree, flows)-regenerations — and checks
the MDS property via max-flow: the file is recoverable from a set K of k
storage nodes iff min-cut(s, DC_K) >= M (Lemma 1).  This is the tool the
paper uses both to prove its schemes safe (Theorems 3, 5) and to exhibit
RCTREE's failure (Appendix A).

Graph construction (Section IV-A):
  * source s -> u_in (inf) for each initial node u;
  * u_in -> u_out with capacity alpha for every storage node;
  * repair of newcomer w over tree T with flows f:
      - provider u sending f(u, x) to interior provider x:  u_out -> x_out
        (capacity f(u, x)) — the relay re-encodes in flight, it does not
        pass through x's storage;
      - provider u sending f(u, w) to the newcomer:  u_out -> w_in;
  * data collector DC -> k chosen out-nodes with infinite capacity.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .params import CodeParams, Edge

INF = float("inf")


@dataclasses.dataclass
class RepairEvent:
    """One regeneration: ``newcomer`` (storage-node id) regenerated from the
    providers appearing in ``tree`` with per-edge block counts ``flows``.

    ``tree``/``flows`` are keyed on *storage-node ids* (not overlay indices);
    the newcomer is the tree root.
    """

    newcomer: int
    parent: Dict[int, int]          # provider -> parent (parent may be newcomer)
    flows: Dict[Edge, float]        # (u, parent(u)) -> blocks


class _MaxFlow:
    """Dinic with float capacities (graphs here have < 10^3 nodes)."""

    def __init__(self):
        self.graph: List[List[int]] = []
        self.to: List[int] = []
        self.cap: List[float] = []

    def add_node(self) -> int:
        self.graph.append([])
        return len(self.graph) - 1

    def add_edge(self, u: int, v: int, c: float) -> None:
        self.graph[u].append(len(self.to))
        self.to.append(v)
        self.cap.append(c)
        self.graph[v].append(len(self.to))
        self.to.append(u)
        self.cap.append(0.0)

    def max_flow(self, s: int, t: int, limit: float = INF) -> float:
        flow = 0.0
        eps = 1e-9
        while flow < limit - eps:
            # BFS level graph
            level = [-1] * len(self.graph)
            level[s] = 0
            q = [s]
            for u in q:
                for e in self.graph[u]:
                    if self.cap[e] > eps and level[self.to[e]] < 0:
                        level[self.to[e]] = level[u] + 1
                        q.append(self.to[e])
            if level[t] < 0:
                break
            it = [0] * len(self.graph)

            def dfs(u: int, f: float) -> float:
                if u == t:
                    return f
                while it[u] < len(self.graph[u]):
                    e = self.graph[u][it[u]]
                    v = self.to[e]
                    if self.cap[e] > eps and level[v] == level[u] + 1:
                        d = dfs(v, min(f, self.cap[e]))
                        if d > eps:
                            self.cap[e] -= d
                            self.cap[e ^ 1] += d
                            return d
                    it[u] += 1
                return 0.0

            while True:
                f = dfs(s, limit - flow)
                if f <= eps:
                    break
                flow += f
        return flow


class InfoFlowGraph:
    """Information flow graph over a repair history."""

    def __init__(self, params: CodeParams, initial_nodes: Sequence[int]):
        self.params = params
        self.events: List[RepairEvent] = []
        self.initial = list(initial_nodes)
        self.live: List[int] = list(initial_nodes)   # current storage nodes

    def fail_and_repair(self, failed: int, event: RepairEvent) -> None:
        if failed not in self.live:
            raise ValueError(f"node {failed} is not live")
        providers = set(event.parent.keys())
        if len(providers) != self.params.d:
            raise ValueError(f"need exactly d={self.params.d} providers, got {len(providers)}")
        if not providers <= set(self.live) - {failed}:
            raise ValueError("providers must be live survivors")
        self.live.remove(failed)
        self.live.append(event.newcomer)
        self.events.append(event)

    # -- flow-graph assembly -------------------------------------------------
    #
    # Deviation from the paper's construction: the
    # paper adds relay links u_out -> w_out directly.  That lets information
    # relayed through w (but never *stored* by w, which keeps only alpha
    # blocks) be read by later consumers of w_out.  We instead create one
    # relay node per (event, provider): w's in-flight transmission may use
    # all of w's stored data (w_out -> w_ev, inf) plus what its tree children
    # delivered this round (child_ev -> w_ev, f(child, w)), and is capped by
    # the tree edge it sends on.  This is never larger than the paper's
    # min-cut, so schemes verified safe here are safe in the paper's model.

    def _build(self) -> Tuple[_MaxFlow, int, Dict[Tuple[int, int], int]]:
        """Returns (flow net, source id, (node, generation) -> out-node id).

        A storage id can be reused across time (replacement hosts); each
        (id, generation) pair is a distinct graph node.  ``gen[node]`` below
        tracks the latest generation per id as events are replayed.
        """
        net = _MaxFlow()
        s = net.add_node()
        alpha = self.params.alpha
        node_in: Dict[Tuple[int, int], int] = {}
        node_out: Dict[Tuple[int, int], int] = {}
        gen: Dict[int, int] = {}

        def new_storage(nid: int, from_source: bool) -> None:
            g = gen.get(nid, -1) + 1
            gen[nid] = g
            i = net.add_node()
            o = net.add_node()
            node_in[(nid, g)] = i
            node_out[(nid, g)] = o
            net.add_edge(i, o, alpha)
            if from_source:
                net.add_edge(s, i, INF)

        for nid in self.initial:
            new_storage(nid, from_source=True)

        for ev in self.events:
            # per-event relay nodes for every provider in the tree
            relay: Dict[int, int] = {}
            for u in ev.parent:
                relay[u] = net.add_node()
                gu = gen[u]
                net.add_edge(node_out[(u, gu)], relay[u], INF)
            new_storage(ev.newcomer, from_source=False)
            g_new = gen[ev.newcomer]
            for u, p in ev.parent.items():
                f = ev.flows[(u, p)]
                if p == ev.newcomer:
                    net.add_edge(relay[u], node_in[(ev.newcomer, g_new)], f)
                else:
                    net.add_edge(relay[u], relay[p], f)
        cur_out = {nid: node_out[(nid, gen[nid])] for nid in self.live}
        return net, s, cur_out

    # -- MDS checks ----------------------------------------------------------

    def collector_flow(self, nodes: Sequence[int]) -> float:
        """Max-flow from source to a data collector on ``nodes``."""
        net, s, cur_out = self._build()
        dc = net.add_node()
        for nid in nodes:
            net.add_edge(cur_out[nid], dc, INF)
        return net.max_flow(s, dc, limit=self.params.M * (1 + 1e-9) + 1.0)

    def mds_holds(self, tol: float = 1e-6) -> bool:
        """True iff every k-subset of live nodes can rebuild the file."""
        return self.worst_collector()[1] >= self.params.M * (1 - tol)

    def worst_collector(self) -> Tuple[Tuple[int, ...], float]:
        worst, worst_flow = (), INF
        for combo in itertools.combinations(sorted(self.live), self.params.k):
            f = self.collector_flow(combo)
            if f < worst_flow:
                worst, worst_flow = combo, f
        return worst, worst_flow


def event_from_plan(plan, newcomer_id: int, provider_ids: Sequence[int]) -> RepairEvent:
    """Translate an overlay-indexed RepairPlan (0 = newcomer, 1..d = providers)
    into a storage-id RepairEvent."""
    idmap = {0: newcomer_id}
    for i, pid in enumerate(provider_ids, start=1):
        idmap[i] = pid
    parent = {idmap[u]: idmap[p] for u, p in plan.parent.items()}
    flows = {(idmap[u], idmap[p]): f for (u, p), f in plan.flows.items()}
    return RepairEvent(newcomer=newcomer_id, parent=parent, flows=flows)
