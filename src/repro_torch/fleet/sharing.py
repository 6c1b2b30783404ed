"""Fair-share model for directed links used by concurrent regenerations.

Every active repair (and every phantom degraded-read stream) *occupies* the
directed physical links its plan sends data over.  A link of capacity ``c``
with ``m`` occupants gives each of them the fair share ``c / m`` — the fluid
approximation of per-flow max-min fairness on independent links.  Repair
progress is store-and-forward over the plan tree, so a repair's *nominal
duration* under the current shares is

    T = max over plan edges e of  f_e / share(link(e))

exactly the paper's regeneration-time expression with capacities replaced
by shares.  Between events a repair advances at rate ``1 / T`` of its total
work; the simulator integrates the remaining-work fraction piecewise.

Consequences the tests pin down (tests/test_fleet.py):

* a lone repair sees full capacities — its fleet time equals ``plan.time``;
* repairs over disjoint links do not affect each other at all;
* two plans bottlenecked on one shared saturated link each see ``c / 2``
  and slow down by exactly 2x while they overlap.

All divisions are guarded: a zero-capacity link yields an ``inf`` nominal
duration (the repair stalls, matching ``plan_time``'s convention), never a
ZeroDivisionError; flows below ``FLOW_EPS`` occupy nothing.

Progress is a *vector*, not a scalar: each repair tracks blocks
received per physical link (``ActiveRepair.bank`` + the in-flight lockstep
fraction).  On a provider-loss abort the banked blocks survive with the
queued slot, and on re-admission or in-flight migration
:func:`apply_credit` subtracts them from the new plan's edge demands —
only the missing flows are re-transferred.  With carryover and migration
disabled the bank stays empty and every arithmetic step reduces bitwise to
the scalar-\\ ``remaining`` model this replaces.

Plan vs reality: the model distinguishes a *believed* view (what
policies plan against and ETAs are predicted from) from the *true* view
(what flows actually achieve).  ``believed`` is an optional separate
capacity matrix the simulator refreshes on its estimate schedule —
:meth:`residual_overlay`, :meth:`residual` and :meth:`admission_time` read
it; ``out_mult`` is an optional per-source-node multiplier vector modelling
silent link brownouts (stragglers/stalls) — :meth:`share` and
:meth:`nominal_time` apply it, so actual progress slows while the believed
view stays oblivious.  Both default to off (``believed=None`` aliases the
true matrix, ``out_mult=None`` skips the multiply), which keeps the default
path bitwise identical to the pre-robustness model.

Incremental sharing engine: :meth:`recompute` no longer rescans
every active repair on every event.  The model keeps a link -> repairs
index (populated by passing ``repair=`` to :meth:`acquire` /
:meth:`release`) and a set of *touched* links — links whose user count
changed since the last recompute, plus links invalidated by capacity
changes (:meth:`invalidate_all` for in-place matrix rescales,
:meth:`invalidate_source` for per-node brownout multiplier flips).  A
recompute then refreshes only the repairs occupying a touched link.  This
is bitwise identical to the full rescan because a repair's nominal
duration is a pure function of (its residual links, the true capacities,
the per-link user counts): if none of those inputs changed, recomputing
would reproduce the exact same float.  The full rescan survives two ways:
as the automatic fallback whenever the index cannot be trusted (callers
that never register repairs, e.g. the closed-form tests), and as a debug
oracle behind ``LinkShareModel(caps, check=True)``, which re-derives every
nominal from scratch after each incremental update and asserts bitwise
equality (tests/test_sharing_incremental.py drives random
arrival/departure/brownout/shock sequences through it).

The occupancy ledger is also mirrored into a dense ``users_mat`` array so
:meth:`residual_overlay` / :meth:`residual_overlays` are single gather +
divide array programs over repairs x links instead of per-entry Python
loops (``x / 1.0`` is IEEE-exact, so dividing untouched entries by one is
bitwise identical to not dividing them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import RepairPlan

Link = Tuple[int, int]          # directed physical link (src node, dst node)

FLOW_EPS = 1e-12                # flows at/below this occupy no link


def plan_links(plan: RepairPlan, ids: Sequence[int],
               ) -> List[Tuple[Link, float]]:
    """Map a plan's tree edges onto physical links.

    ``ids[i]`` is the cluster node standing at overlay index ``i`` (index 0
    = the replacement/newcomer).  Edges with negligible flow are dropped —
    they move no data and must not claim a share.
    """
    out: List[Tuple[Link, float]] = []
    for (u, v), f in plan.flows.items():
        if f > FLOW_EPS:
            out.append(((ids[u], ids[v]), float(f)))
    return out


def apply_credit(flows: Sequence[Tuple[Link, float]],
                 bank: Dict[Link, float],
                 ) -> Tuple[List[Tuple[Link, float]], float, float]:
    """Subtract banked blocks from a plan's per-link demands.

    Returns ``(residual links, credited blocks, total planned blocks)``.
    Credit on each link is capped at the plan's demand there; links whose
    demand is fully prepaid drop out (they move no further data and must
    not claim a share).  Bank entries on links the plan does not use are
    left untouched in ``bank`` — they stay available for a later
    migration back onto those links.
    """
    out: List[Tuple[Link, float]] = []
    credited = 0.0
    total = 0.0
    for link, f in flows:
        total += f
        credit = min(bank.get(link, 0.0), f)
        credited += credit
        resid = f - credit
        if resid > FLOW_EPS:
            out.append((link, resid))
    return out, credited, total


@dataclasses.dataclass(slots=True)
class ActiveRepair:
    """A regeneration in flight, with per-plan-edge progress state.

    ``links`` holds the *residual* demand per physical link fixed at the
    last (re)plan: the plan's per-edge flows minus any banked credit.
    ``remaining`` is the fraction of that residual work left (1 at a fresh
    (re)plan); ``nominal`` is the duration the residual work would take at
    the *current* shares.  Time to finish right now is
    ``remaining * nominal``.

    Progress is fluid store-and-forward: every residual edge advances in
    lockstep fraction ``1 - remaining``, so a child edge has always
    delivered the same fraction of its demand as its parent — no node ever
    forwards blocks it has not received.  ``bank`` records blocks received
    *before* the last (re)plan (per physical link, across the repair's
    whole life); :meth:`banked_now` folds the in-flight fraction on top.

    The progress-vector invariant (pinned by tests/test_fleet.py): for
    every edge of the current plan,

        banked_now(e) + remaining * residual(e) == plan flow on e

    i.e. banked plus outstanding work always equals the plan total —
    credit transfer never creates or destroys work.
    """

    node: int                           # slot being regenerated
    plan: RepairPlan
    ids: List[int]                      # overlay index -> cluster node
    links: List[Tuple[Link, float]]     # physical link -> residual demand
    fail_time: float
    start_time: float
    bank: Dict[Link, float] = dataclasses.field(default_factory=dict)
    remaining: float = 1.0
    nominal: float = math.inf
    # -- plan-vs-reality bookkeeping (inert unless the watchdog /
    #    estimate machinery is on, except the plan-error observation) ------
    plan_t0: float = 0.0                # time of the last (re)plan
    predicted: float = math.inf         # ETA predicted at the last (re)plan
    #                                     under the *believed* capacities
    retries: int = 0                    # watchdog mitigation attempts so far
    next_check: float = 0.0             # watchdog skips this repair until
    #                                     then (exponential backoff)
    avoid: Tuple[int, ...] = ()         # providers evicted as stragglers —
    #                                     not re-drawn while alternatives
    #                                     exist
    rid: int = -1                       # repair id for the flight recorder
    #                                    : stable across aborts,
    #                                     evictions and re-admissions, so a
    #                                     slot's whole lifecycle shares one
    #                                     span tree.  -1 when tracing is off

    @property
    def providers(self) -> List[int]:
        return list(self.ids[1:])

    def eta(self) -> float:
        if self.remaining <= 0.0:
            return 0.0
        return self.remaining * self.nominal

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"negative time step {dt}")
        if math.isfinite(self.nominal) and self.nominal > 0:
            self.remaining = max(0.0, self.remaining - dt / self.nominal)
        elif self.nominal == 0.0:       # degenerate all-tiny-flow plan
            self.remaining = 0.0

    def banked_now(self) -> Dict[Link, float]:
        """Blocks received per physical link as of right now: the bank
        fixed at the last (re)plan plus the in-flight lockstep fraction of
        every residual edge."""
        out = dict(self.bank)
        done = 1.0 - self.remaining
        if done > 0.0:
            for link, resid in self.links:
                out[link] = out.get(link, 0.0) + done * resid
        return out

    def rebase(self, plan: RepairPlan,
               links: List[Tuple[Link, float]],
               bank: Dict[Link, float]) -> None:
        """Migrate onto ``plan``: residual ``links`` (post-credit) become
        the new work vector and progress restarts at fraction 1 — the
        banked work lives on in ``bank``."""
        self.plan = plan
        self.links = links
        self.bank = bank
        self.remaining = 1.0
        self.nominal = math.inf

    def work_accounting(self,
                        ) -> Dict[Link, Tuple[float, float, float]]:
        """Per current-plan link: (banked, outstanding, plan total) — the
        conservation triple the progress-vector invariant constrains.
        Banked counts only blocks attributable to this plan's edge (credit
        at the last (re)plan plus the in-flight lockstep fraction), so
        banked + outstanding == plan total identically."""
        resid0 = dict(self.links)
        done = 1.0 - self.remaining
        out = {}
        for link, f in plan_links(self.plan, self.ids):
            r0 = resid0.get(link, 0.0)
            credit = f - r0         # blocks credited at the last (re)plan
            out[link] = (credit + done * r0, self.remaining * r0, f)
        return out


class LinkShareModel:
    """Occupancy ledger over the cluster's directed capacity matrix.

    Holds a *reference* to ``caps`` so capacity shocks (the simulator
    rescales the matrix in place) are seen by the next ``recompute``.

    ``believed`` (optional) is the planner-side view of the matrix: when
    set, predictions (:meth:`residual`, :meth:`residual_overlay`,
    :meth:`admission_time`) read it while actual rates (:meth:`share`,
    :meth:`nominal_time`) keep reading ``caps``.  ``out_mult`` (optional)
    is a per-source-node rate multiplier for silent brownouts: it scales
    the *true* rates only — a degraded node looks fine to the planner.

    ``tracer`` (optional) observes the occupancy ledger: every
    per-link user-count change in :meth:`acquire` / :meth:`release` is
    reported to ``tracer.on_users(link, users)`` (the
    ``repro_torch.obs.timeline.LinkUsageTracer`` contract), from which exact
    utilization/contention timelines are integrated online.  ``None``
    (default) skips the calls — the share arithmetic itself is never
    touched, so tracing cannot perturb a run.

    Incremental recompute: callers that pass ``repair=`` to
    :meth:`acquire` / :meth:`release` opt into delta recomputes — only
    repairs occupying a link whose user count (or effective capacity, via
    :meth:`invalidate_all` / :meth:`invalidate_source`) changed since the
    last :meth:`recompute` get their nominal refreshed.  Callers that
    never register fall back to the full rescan automatically.
    ``check=True`` keeps the incremental path but re-derives every nominal
    from scratch after each recompute and asserts bitwise equality — the
    debug oracle the property tests drive.
    """

    def __init__(self, caps: np.ndarray,
                 believed: Optional[np.ndarray] = None,
                 check: bool = False):
        self.caps = caps
        self.believed = believed
        self.out_mult: Optional[np.ndarray] = None
        self.tracer = None
        self.check = check
        self.users: Dict[Link, int] = {}
        # dense mirror of ``users`` for the vectorized overlay gathers;
        # int64 keeps ``m + 1.0`` exact for any realistic user count
        self.users_mat = np.zeros(caps.shape, dtype=np.int64)
        # -- incremental-recompute index --------------------------
        self._by_link: Dict[Link, Dict[int, ActiveRepair]] = {}
        self._reg: Dict[int, ActiveRepair] = {}         # all registered
        self._unlinked: Dict[int, ActiveRepair] = {}    # registered, no
        #                                                 residual links
        self._touched: set = set()      # links whose users/capacity changed
        self._all_touched = True        # capacities unseen yet: full scan

    def true_cap(self, link: Link) -> float:
        """Actual capacity of ``link`` right now (brownouts applied)."""
        c = float(self.caps[link])
        if self.out_mult is not None:
            c *= float(self.out_mult[link[0]])
        return c

    def believed_cap(self, link: Link) -> float:
        """Capacity of ``link`` according to the planner's current view."""
        mat = self.caps if self.believed is None else self.believed
        return float(mat[link])

    def acquire(self, links: Sequence[Tuple[Link, float]],
                repair: Optional[ActiveRepair] = None) -> None:
        """Claim one occupancy unit per link.  Passing the owning
        ``repair`` registers it in the link -> repairs index so the next
        :meth:`recompute` can refresh only affected repairs; anonymous
        flows (degraded reads) still mark their links touched."""
        users = self.users
        mat = self.users_mat
        touched = self._touched
        tracer = self.tracer
        for link, _ in links:
            m = users.get(link, 0) + 1
            users[link] = m
            mat[link] = m
            touched.add(link)
            if tracer is not None:
                tracer.on_users(link, m)
        if repair is not None:
            key = id(repair)
            self._reg[key] = repair
            if links:
                for link, _ in links:
                    self._by_link.setdefault(link, {})[key] = repair
            else:
                # a fully-prepaid plan occupies nothing but still needs its
                # (zero) nominal set by the next recompute
                self._unlinked[key] = repair

    def release(self, links: Sequence[Tuple[Link, float]],
                repair: Optional[ActiveRepair] = None) -> None:
        users = self.users
        mat = self.users_mat
        touched = self._touched
        tracer = self.tracer
        for link, _ in links:
            m = users.get(link, 0) - 1
            if m > 0:
                users[link] = m
                mat[link] = m
            else:
                users.pop(link, None)
                mat[link] = 0
            touched.add(link)
            if tracer is not None:
                tracer.on_users(link, max(m, 0))
        if repair is not None:
            key = id(repair)
            self._reg.pop(key, None)
            self._unlinked.pop(key, None)
            for link, _ in links:
                d = self._by_link.get(link)
                if d is not None:
                    d.pop(key, None)
                    if not d:
                        del self._by_link[link]

    # -- capacity-change invalidation -----------------------------

    def invalidate_all(self) -> None:
        """Every effective capacity may have changed (the simulator
        rescaled ``caps`` in place): the next :meth:`recompute` falls back
        to the full rescan."""
        self._all_touched = True

    def invalidate_source(self, node: int) -> None:
        """``node``'s outgoing effective rates changed (brownout applied
        or lifted): mark its occupied outgoing links touched so their
        repairs get re-shared at the next :meth:`recompute`."""
        touched = self._touched
        for link in self._by_link:
            if link[0] == node:
                touched.add(link)

    def share(self, link: Link) -> float:
        """Bandwidth each current occupant of ``link`` receives."""
        c = self.true_cap(link)
        m = max(self.users.get(link, 0), 1)
        return c / m

    def residual(self, link: Link) -> float:
        """Bandwidth a *new* occupant of ``link`` would get, as believed."""
        c = self.believed_cap(link)
        return c / (self.users.get(link, 0) + 1)

    def residual_overlay(self, ids: Sequence[int],
                         exclude: frozenset = frozenset()) -> np.ndarray:
        """(d+1, d+1) overlay capacity matrix for planning a new repair.

        Entry [i, j] is the fair share a new flow on physical link
        (ids[i], ids[j]) would get — the "current residual capacity" the
        flexible policy plans under.  ``exclude`` discounts one existing
        claim on each named link: when an *in-flight* repair evaluates its
        own migration, its current occupancy must not be charged against
        the plans that would replace it.

        Reads the *believed* matrix when one is set — this is the
        planner's map, not the territory (``sim.py`` keeps them apart when
        estimate error is injected).

        One gather + one divide over the dense ``users_mat`` mirror
        (entries with no users divide by exactly 1.0, which is IEEE-exact,
        so the result is bitwise identical to the per-entry loop this
        replaced).
        """
        idx = np.asarray(ids)
        mat = self.caps if self.believed is None else self.believed
        cap = mat[np.ix_(idx, idx)].copy()
        m = self.users_mat[np.ix_(idx, idx)].astype(np.float64)
        if exclude:
            pos = {int(u): i for i, u in enumerate(idx)}
            for (u, v) in exclude:
                i = pos.get(u)
                j = pos.get(v)
                if i is not None and j is not None and m[i, j] > 0:
                    m[i, j] -= 1.0
        cap /= np.where(m > 0, m + 1.0, 1.0)
        np.fill_diagonal(cap, 0.0)
        return cap

    def residual_overlays(self, ids_list: Sequence[Sequence[int]],
                          excludes: Optional[Sequence[frozenset]] = None,
                          ) -> np.ndarray:
        """Stacked ``(R, d+1, d+1)`` residual overlays, one row per
        candidate repair — the batched form of :meth:`residual_overlay`
        the simulator feeds to ``policy.plan_batch`` / ``policy.replan``.
        All id tuples must share one fan-out (the simulator groups
        admissions and replans by d); ``excludes[r]``, when given,
        discounts repair r's own claims exactly like the scalar method.
        Bitwise identical to stacking R scalar calls."""
        idx = np.asarray(ids_list)
        mat = self.caps if self.believed is None else self.believed
        rows = idx[:, :, None]
        cols = idx[:, None, :]
        cap = mat[rows, cols].astype(np.float64, copy=True)
        m = self.users_mat[rows, cols].astype(np.float64)
        if excludes is not None:
            for r, excl in enumerate(excludes):
                if not excl:
                    continue
                pos = {int(u): i for i, u in enumerate(idx[r])}
                for (u, v) in excl:
                    i = pos.get(u)
                    j = pos.get(v)
                    if i is not None and j is not None and m[r, i, j] > 0:
                        m[r, i, j] -= 1.0
        cap /= np.where(m > 0, m + 1.0, 1.0)
        w = cap.shape[1]
        cap[:, np.arange(w), np.arange(w)] = 0.0
        return cap

    def admission_time(self, links: Sequence[Tuple[Link, float]],
                       exclude: frozenset = frozenset()) -> float:
        """Store-and-forward duration the given residual demands would see
        if admitted *now* (each link charged as one new occupant).  With
        ``exclude`` = an in-flight repair's current links, this is the
        migrated-plan ETA the simulator compares against ``eta()``.  A
        *prediction*, so it reads the believed matrix when one is set."""
        mat = self.caps if self.believed is None else self.believed
        users = self.users
        t = 0.0
        for link, f in links:
            if f <= FLOW_EPS:
                continue
            c = float(mat[link])
            m = users.get(link, 0)
            if link in exclude and m:
                m -= 1
            s = c / (m + 1)
            if s <= 0.0:
                return math.inf
            tl = f / s
            if tl > t:
                t = tl
        return t

    def nominal_time(self, links: Sequence[Tuple[Link, float]]) -> float:
        """Store-and-forward duration of a plan at the current shares.

        Same arithmetic as ``max(f / self.share(link))`` with the
        attribute lookups hoisted — this is the recompute hot loop."""
        caps = self.caps
        om = self.out_mult
        users = self.users
        t = 0.0
        for link, f in links:
            if f <= FLOW_EPS:
                continue
            c = float(caps[link])
            if om is not None:
                c *= float(om[link[0]])
            m = users.get(link, 0)
            if m > 1:
                s = c / m
            else:
                s = c
            if s <= 0.0:
                return math.inf
            tl = f / s
            if tl > t:
                t = tl
        return t

    def recompute(self, active: Sequence[ActiveRepair]) -> None:
        """Refresh active repairs' nominal durations (call after any
        arrival, departure, or capacity change).

        When every repair in ``active`` is registered (the simulator's
        path), only repairs occupying a *touched* link are refreshed — a
        repair none of whose links changed users or capacity would
        recompute to the bit-identical float, so skipping it is exact.
        Unregistered callers (or a global invalidation) get the full
        rescan.  With ``check=True`` a full rescan shadows every
        incremental result and asserts bitwise equality."""
        if self._all_touched or len(self._reg) != len(active):
            for r in active:
                r.nominal = self.nominal_time(r.links)
            self._all_touched = False
            self._touched.clear()
            return
        touched = self._touched
        if touched:
            by_link = self._by_link
            seen: set = set()
            nominal_time = self.nominal_time
            for link in touched:
                d = by_link.get(link)
                if d:
                    for key, r in d.items():
                        if key not in seen:
                            seen.add(key)
                            r.nominal = nominal_time(r.links)
            touched.clear()
        for r in self._unlinked.values():
            r.nominal = self.nominal_time(r.links)      # == 0.0 always
        if self.check:
            for r in active:
                want = self.nominal_time(r.links)
                assert r.nominal == want, (
                    f"incremental recompute diverged for repair of slot "
                    f"{r.node}: incremental={r.nominal!r} full={want!r}")
