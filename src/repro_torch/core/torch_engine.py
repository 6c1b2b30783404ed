"""The device planning tier: star, FR, TR, FTR and Shah over a batch of
overlays as float64 torch programs, on the card or (when asked) the CPU.

The counterpart of ``repro.core.batched`` (the NumPy lockstep engine) and of
``repro.core.jax_engine`` (its jit tier), ported from the latter: every lane
issues every oracle query, masked with ``torch.where`` so that lanes out of
play probe a benign t = 1.0 whose answer is ignored; the scalar planners'
decision sequences (incumbent pruning, duplicate skips, pivot accept order,
stable-sort tie breaks) are kept operation for operation.  Lanes are
independent, so a batch equals its lanes planned one by one.

Eager torch launches every operation from the host, so what costs here is
launches and device-to-host reads, not arithmetic.  The design follows:

* a bisection evaluates all 2^L - 1 midpoints of its next L levels in one
  oracle call (``_SPEC_LEVELS``) and walks the realized path; the midpoints
  come from the same ``0.5 * (lo + hi)`` recurrence, so the result is
  bitwise that of plain bisection;
* the water-fill needs at most d rounds (a lane freezes at least one
  coordinate a round, and a round after a lane has frozen them all changes
  nothing in it); it reads ``active.any()`` after every round to stop
  early, since most calls end after a few rounds;
* loops whose length depends on the data (hi-doubling, the local search's
  probe waves) read one flag from the device per pass, and refinements run
  on the lanes that need them only;
* ``syncs`` counts the engine's own device-to-host reads, and the
  counters ``plan.reads.<site>`` (``obs.spans``) count them by call site;
  the spans ``plan.waterfill``, ``plan.bisect`` and
  ``plan.ftr.local_search.probe`` (a probe wave) name the host's time in
  the loops that make most of them;
* the reference's stages (``closed_form``, ``star_bisection``,
  ``witness``; ``tr_seed``, ``candidates``, ``local_search``,
  ``final_solve``, ``witness``) are spans ``plan.<scheme>.<stage>`` on the
  profiler's clock; ``profile=`` (fr and ftr) also times them and counts
  the work items, each stage then ending in a synchronize on the card.
  Only a profiled plan reads the device for them (``plan.reads.profile``,
  not counted in ``syncs``).

Float64 is named on every float tensor (torch defaults to float32), and
parents are int64.  The reductions (the cumsum of the region check, the
water-fill's ``inc @ X``, the traffic sums) may associate differently from
NumPy's, so the tier agrees with the scalar planners within 1e-9 relative;
tree parents are equal save where two trees tie.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Tuple

import torch

from ..obs import spans
from .batched import BatchPlanResult, star_parents
from .ftr import (EVAL_ITERS, FINAL_ITERS, LOCAL_SEARCH_ALTS,
                  LOCAL_SEARCH_ROUNDS, PROBE_SLACK, REFINE_ITERS)
from .lp import BISECT_ITERS
from .params import CodeParams
from .regions import (FeasibleRegion, heuristic_region, msr_region,
                      shah_region_thresholds)

__all__ = ["plan_fr_batch", "plan_ftr_batch", "plan_shah_batch",
           "plan_star_batch", "plan_tr_batch", "syncs"]

F64 = torch.float64
INF = float("inf")
_SPEC_LEVELS = 4        # bisection levels evaluated per oracle call
_DOUBLINGS = 4          # hi doublings between reads of the exit flag

syncs = 0               # device-to-host reads made by the engine


def _read(site: str, *flags: torch.Tensor) -> list:
    """Scalar flags to the host in one read, counted under ``site``."""
    global syncs
    syncs += 1
    spans.count("plan.reads." + site)
    return torch.stack(flags).tolist()


def _lanes(site: str, mask: torch.Tensor) -> torch.Tensor:
    """Indices of the set lanes (one read, counted under ``site``)."""
    global syncs
    syncs += 1
    spans.count("plan.reads." + site)
    return torch.nonzero(mask).squeeze(1)


@contextlib.contextmanager
def _stage(profile, scheme: str, name: str,
           device: torch.device) -> Iterator[None]:
    """Stage ``name`` of ``scheme``'s planner: always the span
    ``plan.<scheme>.<name>``; with a profile also the ``profile=`` hook's
    stage (the reference's ``_pstage``), which ends when the device's work
    is done.  Stages only measure, never branch, so a profiled plan is the
    same plan."""
    with spans.span(f"plan.{scheme}.{name}"):
        if profile is None:
            yield
            return
        with profile.stage(name):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def _count(profile, **counts) -> None:
    """The profile's counters; a tensor count is read from the device (a
    read of the profile's, ``plan.reads.profile``, not in ``syncs``)."""
    if profile is not None:
        for name, n in counts.items():
            if isinstance(n, torch.Tensor):
                spans.count("plan.reads.profile")
            profile.count(name, int(n))


def _region_for(params: CodeParams,
                region: Optional[FeasibleRegion]) -> FeasibleRegion:
    if region is None:
        return msr_region(params) if params.is_msr else heuristic_region(params)
    return region


def _check_witness(witness: str) -> None:
    if witness != "exact":
        raise ValueError(
            f"engine='batched' supports witness='exact' only (got "
            f"{witness!r}); use engine='scalar' for the LP witness oracle")


# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------

def _subtree_masks(parents: torch.Tensor) -> torch.Tensor:
    """Subtree membership of trees given by parents (P, d+1) int64: float64
    (P, d+1, d) with [p, u, x-1] = 1 iff provider x lies in u's subtree.
    Pointer doubling: log2(d+1) squarings of the one-step reachability."""
    P, D1 = parents.shape
    dev = parents.device
    node = torch.arange(D1, device=dev)
    C = torch.zeros((P, D1, D1), dtype=F64, device=dev)
    C[:, node, node] = 1.0
    C[torch.arange(P, device=dev)[:, None], node[None, 1:],
      parents[:, 1:]] = 1.0
    steps = 1
    while steps < D1:
        C = (C @ C > 0).to(F64)
        steps *= 2
    return C.transpose(1, 2)[:, :, 1:].contiguous()


def _edge_caps(caps: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """[p, u-1] = c(u, parent(u)) for each lane's full tree."""
    P, D1 = parents.shape
    dev = caps.device
    return caps[torch.arange(P, device=dev)[:, None],
                torch.arange(1, D1, device=dev)[None, :], parents[:, 1:]]


def _nest(inc: torch.Tensor) -> torch.Tensor:
    """Nesting relation of a laminar family (P, S, d): sets overlap iff
    nested, so the boolean Gram matrix is the ancestor/descendant relation."""
    return (inc @ inc.transpose(1, 2)) > 0


def _sigma_feasible(beta: torch.Tensor, x: torch.Tensor,
                    tol: float) -> torch.Tensor:
    """Theorem-1 region check over the last axis: sigma_j(beta) >= x_j - tol
    for every j (sort, then cumsum)."""
    d = beta.shape[-1]
    k = x.shape[0]
    sig = torch.cumsum(torch.sort(beta, dim=-1).values, dim=-1)[..., d - k:]
    return (sig >= x - tol).all(dim=-1)


def _waterfill(inc: torch.Tensor, bnd: torch.Tensor,
               alpha: float, chain: torch.Tensor) -> torch.Tensor:
    """Lockstep leximin water-fill (``batched.waterfill_batch``): each round
    freezes the chain-minimal saturated sets of every lane; a lane with no
    freezable set fills its active coordinates to alpha."""
    with spans.span("plan.waterfill"):
        P, S, d = inc.shape
        athr = alpha - 1e-15
        member = inc > 0
        v = torch.zeros((P, d), dtype=F64, device=inc.device)
        active = torch.ones((P, d), dtype=F64, device=inc.device)
        for r in range(d):
            Y = inc @ torch.stack([active, v * (1.0 - active)], dim=-1)
            na = Y[..., 0]
            cand = torch.where(na == 0, INF,
                               (bnd - Y[..., 1]) / na.clamp_min(1.0))
            freezable = cand < athr
            chmin = torch.where(chain, cand[:, None, :], INF).amin(dim=2)
            setfreeze = freezable & (cand <= chmin)
            lamx = torch.where(setfreeze[:, :, None] & member,
                               cand[:, :, None], INF)
            lamx = lamx.amin(dim=1).clamp_min(0.0)
            fin = lamx < INF
            mfrz = fin | ~setfreeze.any(dim=1, keepdim=True)
            v = torch.where(mfrz & (active > 0),
                            torch.where(fin, lamx, alpha), v)
            active = active * ~mfrz
            if r + 1 < d and not _read("waterfill", active.any())[0]:
                break
        return v


def _tree_feasible(t: torch.Tensor, inc: torch.Tensor, ec: torch.Tensor,
                   x: torch.Tensor, alpha: float, chain: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batched.tree_feasible_batch``: binding edges (t*c < alpha - 1e-12)
    bound their subtree sums; the water-fill point is held to the region at
    the scalar oracle's 1e-9 tolerance.  Returns (feasible, water-fill)."""
    bounds = t[:, None] * ec
    bnd = torch.where(bounds < alpha - 1e-12, bounds, INF)
    wf = _waterfill(inc, bnd, alpha, chain)
    return _sigma_feasible(wf, x, 1e-9), wf


def _tree_oracle(inc, ec, chain, x, alpha) -> Callable:
    """Feasibility of each lane's tree at times t (n, w) -> (n, w) bool."""
    reps = {}

    def oracle(t: torch.Tensor) -> torch.Tensor:
        w = t.shape[1]
        if w not in reps:
            reps[w] = tuple(a if w == 1 else a.repeat_interleave(w, dim=0)
                            for a in (inc, ec, chain))
        i, e, c = reps[w]
        f, _ = _tree_feasible(t.reshape(-1), i, e, x, alpha, c)
        return f.view(-1, w)

    return oracle


def _min_level(ub: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact minimal level cut (``witness.min_level_batch`` without its
    raise on an infeasible lane: the planners evaluate it only at a
    certified-feasible time)."""
    B, d = ub.shape
    k = x.shape[0]
    dev = ub.device
    s = torch.sort(ub, dim=1).values
    S = torch.cat([torch.zeros((B, 1), dtype=F64, device=dev),
                   torch.cumsum(s, dim=1)], dim=1)
    p = torch.arange(d, device=dev)
    m = d - k + torch.arange(1, k + 1, device=dev)
    denom = (m[None, :, None] - p[None, None, :]).to(F64)
    cand = (x[None, :, None] - S[:, None, :d]) / denom
    cand = torch.where(denom > 0, cand, -INF)
    return cand.amax(dim=(1, 2)).clamp_min(0.0)


def _level_cut(ub: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(ub, _min_level(ub, x)[:, None])


def _star_time(flows: torch.Tensor, direct: torch.Tensor) -> torch.Tensor:
    """max_i flows_i / c_i, inf on a nonpositive link."""
    return torch.where(direct > 0, flows / direct, INF).amax(dim=1)


# ---------------------------------------------------------------------------
# Bisection, _SPEC_LEVELS levels per oracle call
# ---------------------------------------------------------------------------

def _spec_mids(lo: torch.Tensor, hi: torch.Tensor,
               levels: int) -> torch.Tensor:
    """Breadth-first midpoints of the ``levels``-level bisection tree,
    (n, 2^levels - 1); node i's children are 2i+1 (feasible: [lo, mid]) and
    2i+2 (infeasible: [mid, hi])."""
    n = lo.shape[0]
    los, his = lo[:, None], hi[:, None]
    out = []
    for _ in range(levels):
        m = 0.5 * (los + his)
        out.append(m)
        los = torch.stack([los, m], dim=-1).reshape(n, -1)
        his = torch.stack([m, his], dim=-1).reshape(n, -1)
    return torch.cat(out, dim=1)


def _bisect(oracle: Callable, lo: torch.Tensor, hi: torch.Tensor, iters: int,
            on: torch.Tensor, budget: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` bisection steps on [lo, hi] (feasible: hi = mid, else
    lo = mid) on the lanes ``on``, each lane stopping after ``budget`` steps
    if given.  Lanes out of play query t = 1.0 and keep lo and hi."""
    with spans.span("plan.bisect"):
        n = lo.shape[0]
        done = 0
        while done < iters:
            levels = min(_SPEC_LEVELS, iters - done)
            mids = _spec_mids(lo, hi, levels)
            f = oracle(torch.where(on[:, None], mids, 1.0))
            node = torch.zeros((n, 1), dtype=torch.long, device=lo.device)
            for step in range(levels):
                go = on if budget is None else on & (done + step < budget)
                m = mids.gather(1, node)[:, 0]
                fb = f.gather(1, node)[:, 0]
                hi = torch.where(go & fb, m, hi)
                lo = torch.where(go & ~fb, m, lo)
                node = 2 * node + 2 - fb[:, None].long()
            done += levels
        return lo, hi


def _double(oracle: Callable, hi: torch.Tensor, need: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tree hi-doubling (``batched.tree_optimal_time_batch``): lanes in
    ``need`` double hi until feasible, giving up at 1e18.  Returns (hi,
    lanes that became feasible)."""
    feasd = torch.zeros_like(need)
    while _read("double", need.any())[0]:
        for _ in range(_DOUBLINGS):
            hi = torch.where(need, hi * 2.0, hi)
            over = hi >= 1e18
            f = oracle(torch.where(need & ~over, hi, 1.0)[:, None])[:, 0]
            feasd = feasd | (need & ~over & f)
            need = need & ~feasd & ~over
    return hi, feasd


# ---------------------------------------------------------------------------
# STAR / FR / Shah
# ---------------------------------------------------------------------------

def plan_star_batch(caps: torch.Tensor, params: CodeParams) -> BatchPlanResult:
    """Conventional uniform-beta star regeneration over a batch."""
    B = caps.shape[0]
    d = params.d
    direct = caps[:, 1:, 0]
    flows = torch.full((B, d), min(params.beta, params.alpha), dtype=F64,
                       device=caps.device)
    return BatchPlanResult(
        "star", _star_time(flows, direct), flows.sum(dim=1),
        torch.full((B, d), params.beta, dtype=F64, device=caps.device),
        star_parents(B, d, caps.device))


def _star_optimal_time(direct: torch.Tensor, x: torch.Tensor, alpha: float,
                       lanes: torch.Tensor) -> torch.Tensor:
    """``batched.minmax_time_star_batch``: bisection on the coordinate-wise
    max point, 1e-12 region tolerance; hi-doubling gives up past 1e18."""
    B = direct.shape[0]

    def oracle(t: torch.Tensor) -> torch.Tensor:
        bh = (t[:, :, None] * direct[:, None, :]).clamp_max(alpha)
        return _sigma_feasible(bh, x, 1e-12)

    hi = torch.ones(B, dtype=F64, device=direct.device)
    ok = oracle(hi[:, None])[:, 0] | ~lanes
    while True:
        for _ in range(_DOUBLINGS):
            hi = torch.where(ok, hi, hi * 2.0)
            ok = ok | (hi > 1e18) | oracle(hi[:, None])[:, 0]
        if _read("star.ok", ok.all())[0]:
            break
    dead = lanes & (hi > 1e18)
    _, hi = _bisect(oracle, torch.zeros_like(hi), hi, BISECT_ITERS,
                    torch.ones_like(lanes))
    return torch.where(dead, INF, hi)


def _fr_closed_form(direct: torch.Tensor, closed: torch.Tensor, k: int,
                    M: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``star.fr_closed_form_msr`` on the lanes ``closed``: (betas, time)."""
    B, d = direct.shape
    m = d - k + 1
    safe = torch.where(closed[:, None], direct, 1.0)
    order = torch.argsort(safe, dim=1, stable=True)
    csort = safe.gather(1, order)
    denom = csort[:, :m].sum(dim=1)
    rank = torch.arange(d, device=direct.device)[None, :]
    bsort = (torch.where(rank < m, csort, csort[:, m - 1:m])
             * M / (k * denom[:, None]))
    betas = torch.empty_like(bsort).scatter_(1, order, bsort)
    return betas, (betas / safe).amax(dim=1)


def plan_fr_batch(caps: torch.Tensor, params: CodeParams,
                  region: Optional[FeasibleRegion] = None,
                  minimize_traffic: bool = True,
                  witness: str = "exact", profile=None) -> BatchPlanResult:
    """Flexible Regeneration over a batch: the MSR closed form on lanes with
    every direct link positive, otherwise the star bisection and the
    level-cut witness.  ``profile`` times the ``closed_form`` /
    ``star_bisection`` / ``witness`` stages."""
    _check_witness(witness)
    region = _region_for(params, region)
    B = caps.shape[0]
    d = params.d
    dev = caps.device
    direct = caps[:, 1:, 0]
    x = torch.tensor(region.x, dtype=F64, device=dev)
    betas = torch.zeros((B, d), dtype=F64, device=dev)
    lb = torch.zeros(B, dtype=F64, device=dev)
    closed = torch.zeros(B, dtype=torch.bool, device=dev)
    if params.is_msr:
        closed = (direct > 0).all(dim=1)
        staged = False
        if profile is not None:             # a read of the profile's
            spans.count("plan.reads.profile")
            staged = bool(closed.any())
        with _stage(profile if staged else None, "fr", "closed_form", dev):
            cb, ct = _fr_closed_form(direct, closed, params.k, params.M)
            betas = torch.where(closed[:, None], cb, betas)
            lb = torch.where(closed, ct, lb)
    rest = ~closed
    if _read("fr.rest", rest.any())[0]:
        with _stage(profile, "fr", "star_bisection", dev):
            t_rest = _star_optimal_time(direct, x, params.alpha, rest)
        _count(profile, bisection_iters=BISECT_ITERS)
        lb = torch.where(rest, t_rest, lb)
        live = rest & torch.isfinite(t_rest)
        with _stage(profile, "fr", "witness", dev):
            ub = (torch.where(live, t_rest, 0.0)[:, None] * direct
                  ).clamp_max(params.alpha)
            wb = _level_cut(ub, x) if minimize_traffic else ub
            betas = torch.where(live[:, None], wb, betas)
    _count(profile, lanes=B, closed_form_lanes=closed.sum(),
           bisection_lanes=rest.sum())
    flows = betas.clamp_max(params.alpha)
    times = _star_time(flows, direct).clamp_min(0.0)
    bad = ~torch.isfinite(lb)
    return BatchPlanResult("fr", torch.where(bad, INF, times),
                           torch.where(bad, INF, flows.sum(dim=1)), betas,
                           star_parents(B, d, dev), lower_bounds=lb)


def plan_shah_batch(caps: torch.Tensor, params: CodeParams,
                    beta_max: Optional[float] = None) -> BatchPlanResult:
    """Shah et al. [6] over a batch (``batched.plan_shah_batch``): bisection
    on sum_i min(t*c_i, beta_max) >= gamma, then the ascending-capacity
    surplus trim, with every sum a left-to-right d-step accumulation as in
    the scalar planner."""
    B = caps.shape[0]
    d = params.d
    dev = caps.device
    direct = caps[:, 1:, 0]
    if beta_max is None:
        beta_max = params.alpha
    gamma = shah_region_thresholds(params, beta_max)

    def tot(t: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(t)
        for i in range(d):
            acc = acc + (t * direct[:, i, None]).clamp_max(beta_max)
        return acc

    hi = torch.ones(B, dtype=F64, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    need = tot(hi[:, None])[:, 0] < gamma
    while _read("shah.need", (need & ~dead).any())[0]:
        for _ in range(_DOUBLINGS):
            grow = need & ~dead
            hi = torch.where(grow, hi * 2.0, hi)
            dead = dead | (grow & (hi > 1e18))
            need = tot(hi[:, None])[:, 0] < gamma
    _, t = _bisect(lambda q: tot(q) >= gamma, torch.zeros_like(hi), hi, 60,
                   torch.ones_like(dead))
    betas = (t[:, None] * direct).clamp_max(beta_max)
    acc = torch.zeros(B, dtype=F64, device=dev)
    for i in range(d):
        acc = acc + betas[:, i]
    surplus = acc - gamma
    order = torch.argsort(direct, dim=1, stable=True)
    for j in range(d):
        i = order[:, j:j + 1]
        bi = betas.gather(1, i)[:, 0]
        cut = torch.minimum(surplus.clamp_min(0.0), bi)
        betas = betas.scatter(1, i, (bi - cut)[:, None])
        surplus = surplus - cut
    betas = torch.where(dead[:, None], 0.0, betas)
    flows = betas.clamp_max(params.alpha)
    times = torch.where(dead, INF, _star_time(flows, direct))
    return BatchPlanResult("shah", times, flows.sum(dim=1), betas,
                           star_parents(B, d, dev))


# ---------------------------------------------------------------------------
# TR: Algorithm 1 (incremental greedy, lockstep)
# ---------------------------------------------------------------------------

def _tr_greedy(caps: torch.Tensor, beta: float, alpha: float,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The d-step greedy of ``batched.plan_tr_batch``, with its lexicographic
    (t, -c(v,u), v, u) candidate selection.  Returns (parents, subtree
    sizes, uplink capacities), each (B, d+1)."""
    B, D1, _ = caps.shape
    dev = caps.device
    bidx = torch.arange(B, device=dev)
    new_edge_t = torch.where(caps > 0, min(beta, alpha) / caps, INF)
    parent = torch.zeros((B, D1), dtype=torch.long, device=dev)
    attached = torch.zeros((B, D1), dtype=torch.bool, device=dev)
    attached[:, 0] = True
    anc = torch.zeros((B, D1, D1), dtype=torch.bool, device=dev)
    size = torch.zeros((B, D1), dtype=F64, device=dev)
    edge_c = torch.zeros((B, D1), dtype=F64, device=dev)
    for _ in range(D1 - 1):
        att_e = attached.clone()
        att_e[:, 0] = False
        f_now = (size * beta).clamp_max(alpha)
        f_inc = ((size + 1.0) * beta).clamp_max(alpha)
        h = torch.where(att_e, torch.where(edge_c > 0, f_now / edge_c, INF),
                        -INF)
        g = torch.where(att_e, torch.where(edge_c > 0, f_inc / edge_c, INF),
                        -INF)
        # T_path[u]: partial-tree time if the new provider attaches under u
        t_path = torch.where(anc, g[:, :, None], h[:, :, None]).amax(dim=1)
        cand_t = torch.maximum(new_edge_t, t_path.clamp_min(0.0)[:, None, :])
        valid = (~attached)[:, :, None] & attached[:, None, :]
        cand_t = torch.where(valid, cand_t, INF)
        is_t = valid & (cand_t == cand_t.amin(dim=(1, 2))[:, None, None])
        cgrid = torch.where(is_t, caps, -INF)
        sel = is_t & (cgrid == cgrid.amax(dim=(1, 2))[:, None, None])
        choice = sel.reshape(B, -1).to(torch.uint8).argmax(dim=1)
        v_sel = choice // D1
        u_sel = choice % D1
        parent[bidx, v_sel] = u_sel
        attached[bidx, v_sel] = True
        edge_c[bidx, v_sel] = caps[bidx, v_sel, u_sel]
        size = size + anc[bidx, :, u_sel]
        size[bidx, v_sel] = 1.0
        anc[bidx, :, v_sel] = anc[bidx, :, u_sel]
        anc[bidx, v_sel, v_sel] = True
    return parent, size, edge_c


def plan_tr_batch(caps: torch.Tensor, params: CodeParams) -> BatchPlanResult:
    """Algorithm 1 (greedy regeneration tree, uniform traffic) over a
    batch."""
    B = caps.shape[0]
    beta, alpha = params.beta, params.alpha
    parent, size, edge_c = _tr_greedy(caps, beta, alpha)
    flows = (size[:, 1:] * beta).clamp_max(alpha)
    et = torch.where(edge_c[:, 1:] > 0, flows / edge_c[:, 1:], INF)
    return BatchPlanResult(
        "tr", et.amax(dim=1), flows.sum(dim=1),
        torch.full((B, params.d), beta, dtype=F64, device=caps.device),
        parent)


# ---------------------------------------------------------------------------
# FTR: Algorithm 2 (candidate population + pivot local search), lockstep
# ---------------------------------------------------------------------------

def _ftr_candidates(caps: torch.Tensor,
                    tr_parents: torch.Tensor) -> torch.Tensor:
    """Algorithm 2's initial trees, core sizes i = 0..d, plus the TR tree:
    (B, d+2, d+1) parents.  The max-capacity core greedy is deterministic,
    so one growth pass gives every core as a prefix."""
    B, D1, _ = caps.shape
    dev = caps.device
    bidx = torch.arange(B, device=dev)
    in_core = torch.zeros((B, D1), dtype=torch.bool, device=dev)
    in_core[:, 0] = True
    core_pos = torch.full((B, D1), D1 + 1, dtype=torch.long, device=dev)
    core_pos[:, 0] = 0
    parfull = torch.zeros((B, D1), dtype=torch.long, device=dev)
    for step in range(D1 - 1):
        cuv = torch.where(~in_core[:, :, None] & in_core[:, None, :], caps,
                          -INF)
        cuv[:, 0, :] = -INF
        rowbest = cuv.amax(dim=2)
        u_sel = rowbest.argmax(dim=1)
        best = rowbest[bidx, u_sel]
        # attach point: the first core node, in core order, with the max
        pos = torch.where(cuv[bidx, u_sel, :] == best[:, None], core_pos,
                          D1 + 2)
        parfull[bidx, u_sel] = pos.argmin(dim=1)
        in_core[bidx, u_sel] = True
        core_pos[bidx, u_sel] = step + 1
    ii = torch.arange(D1, device=dev)[None, :, None]
    mask_core = core_pos[:, None, :] <= ii                  # (B, d+1, D1)
    cu = torch.where(mask_core[:, :, None, :], caps[:, None, :, :], -INF)
    mx = cu.amax(dim=3)
    posg = torch.where(cu == mx[..., None], core_pos[:, None, None, :],
                       D1 + 2)
    par = torch.where(mask_core, parfull[:, None, :], posg.argmin(dim=3))
    par[:, :, 0] = 0
    return torch.cat([par, tr_parents[:, None, :]], dim=1)


def _tree_arrays(caps: torch.Tensor, parents: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(subtree sets (P, d, d), uplink capacities (P, d), nesting (P, d, d))
    of full trees given by their parents."""
    inc = _subtree_masks(parents)[:, 1:, :]
    return inc, _edge_caps(caps, parents), _nest(inc)


def _candidate_times(caps: torch.Tensor, cands: torch.Tensor, x: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Per-candidate optimal times with the scalar planner's incumbent
    pruning, lockstep over candidates: candidate c is probed at the lane's
    incumbent (28-step refinement on accept, inf on reject); a lane with no
    finite incumbent runs the full 40-step solve.  Duplicate and
    zero-capacity candidates are skipped as in the scalar planner."""
    B, C, D1 = cands.shape
    d = D1 - 1
    dev = caps.device
    lane_of = torch.arange(B, device=dev).repeat_interleave(C)
    flat = cands.reshape(B * C, D1)
    inc_all = _subtree_masks(flat)[:, 1:, :]
    ec_all = _edge_caps(caps[lane_of], flat)
    ch_all = _nest(inc_all)
    eq = (cands[:, :, None, :] == cands[:, None, :, :]).all(dim=-1)
    earlier = torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
    dup = (eq & earlier[None]).any(dim=2)
    ec_ok = (ec_all > 0).all(dim=1).reshape(B, C)
    hi0_all = ((alpha / torch.where(ec_all > 0, ec_all, 1.0)).amax(dim=1)
               * (1 + 1e-9) + 1e-12).reshape(B, C)
    inc_r = inc_all.reshape(B, C, d, d)
    ec_r = ec_all.reshape(B, C, d)
    ch_r = ch_all.reshape(B, C, d, d)

    t_cand = torch.full((B, C), INF, dtype=F64, device=dev)
    incumbent = torch.full((B,), INF, dtype=F64, device=dev)
    for c in range(C):
        inc, ec, ch = inc_r[:, c], ec_r[:, c], ch_r[:, c]
        oracle = _tree_oracle(inc, ec, ch, x, alpha)
        okl = ~dup[:, c] & ec_ok[:, c]
        has_inc = torch.isfinite(incumbent)
        probe = okl & has_inc
        full = okl & ~has_inc
        # probe lanes ask at the incumbent, full lanes at the initial hi
        t0 = torch.where(probe, incumbent, torch.where(full, hi0_all[:, c],
                                                       1.0))
        f = oracle(t0[:, None])[:, 0]
        pf = f & probe
        hi, feasd = _double(oracle, t0, full & ~f)
        feasd = feasd | (f & full)
        solve = pf | feasd
        idx = _lanes("candidates.lanes", solve)
        if not idx.numel():
            continue
        # only a lane with no incumbent (always so at c = 0) runs 40 steps
        iters = (EVAL_ITERS if c == 0
                 or _read("candidates.solve", (solve & full).any())[0]
                 else REFINE_ITERS)
        budget = torch.where(full, EVAL_ITERS, REFINE_ITERS)[idx]
        _, h = _bisect(_tree_oracle(inc[idx], ec[idx], ch[idx], x, alpha),
                       torch.zeros_like(hi[idx]), hi[idx], iters,
                       torch.ones_like(budget, dtype=torch.bool), budget)
        t_c = torch.full((B,), INF, dtype=F64, device=dev).index_put((idx,), h)
        t_cand[:, c] = t_c
        incumbent = torch.minimum(incumbent, t_c)
    return t_cand


def _tree_optimal_time(inc, ec, ch, x, alpha, iters: int,
                       lanes: torch.Tensor) -> torch.Tensor:
    """``batched.tree_optimal_time_batch``: hi from the slowest uplink,
    hi-doubling, then ``iters`` bisection steps on the live lanes."""
    valid = lanes & (ec > 0).all(dim=1)
    safe = torch.where(ec > 0, ec, 1.0)
    hi = torch.where(valid, (alpha / safe).amax(dim=1) * (1 + 1e-9) + 1e-12,
                     INF)
    oracle = _tree_oracle(inc, ec, ch, x, alpha)
    f = oracle(torch.where(valid, hi, 1.0)[:, None])[:, 0] & valid
    hi, feasd = _double(oracle, hi, valid & ~f)
    live = valid & (f | feasd)
    _, hi = _bisect(oracle, torch.zeros_like(hi), hi, iters, live)
    return torch.where(live, hi, INF)


def _local_search(caps: torch.Tensor, parents: torch.Tensor,
                  t_cur: torch.Tensor, x: torch.Tensor, alpha: float,
                  alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batched._local_search_batch`` in lockstep: rounds x nodes as a
    fixed loop of (round, u) steps with a per-lane ``running`` mask; within
    a step, probe waves over the node's untried alternatives run until every
    lane has tried them all: the first feasible alternative is accepted, its
    lane refines [0, t_cur], and the remaining alternatives are replayed on
    the updated tree, the scalar pivot sweep's decision sequence."""
    L, D1 = parents.shape
    d = D1 - 1
    A = min(LOCAL_SEARCH_ALTS, D1)
    dev = caps.device
    lidx = torch.arange(L, device=dev)
    parents = parents.clone()
    bm = _subtree_masks(parents)
    ec = _edge_caps(caps, parents)
    ch = _nest(bm[:, 1:, :])
    root_onehot = torch.zeros(D1, dtype=F64, device=dev)
    root_onehot[0] = 1.0
    nodes = torch.arange(D1, device=dev)[None, :]
    aidx = torch.arange(A, device=dev)[None, :]
    colu_all = torch.arange(d, device=dev)
    zero_col = torch.zeros((L, 1), dtype=F64, device=dev)
    improved = torch.zeros(L, dtype=torch.bool, device=dev)
    running = alive
    for s in range(LOCAL_SEARCH_ROUNDS * d):
        u = s % d + 1
        cpu = caps[:, u, :]                                 # (L, D1)
        dsc = bm[:, u, :]                                   # (L, d)
        in_sub = torch.cat([zero_col, dsc], dim=1)
        ok = ((cpu > 0) & (nodes != u) & (nodes != parents[:, u:u + 1])
              & ~(in_sub > 0))
        nok = ok.sum(dim=1).clamp_max(LOCAL_SEARCH_ALTS)
        palt = torch.argsort(torch.where(ok, -cpu, INF), dim=1,
                             stable=True)[:, :A]            # (L, A)
        newc = cpu.gather(1, palt)
        jj = torch.where(running, 0, nok)
        while _read("local_search.probe", (jj < nok).any())[0]:
            with spans.span("plan.ftr.local_search.probe"):
                valid_a = (aidx >= jj[:, None]) & (aidx < nok[:, None])
                # one-edge mask update: u's descendants keep their in-subtree
                # ancestors and adopt the new parent's ancestor chain
                anc_v = torch.where(
                    (palt >= 1)[:, :, None],
                    bm.transpose(1, 2)[lidx[:, None], (palt - 1).clamp_min(0)],
                    root_onehot)                                # (L, A, D1)
                pmask = torch.where(
                    dsc[:, None, None, :] > 0,
                    (bm[:, None] * in_sub[:, None, :, None]
                     + anc_v[..., None]).clamp_max(1.0),
                    bm[:, None])                                # (L, A, D1, d)
                pec = torch.where(colu_all == u - 1, newc[:, :, None],
                                  ec[:, None, :])               # (L, A, d)
                pinc = pmask[:, :, 1:, :].reshape(L * A, d, d)
                pch = _nest(pinc)
                tq = torch.where(valid_a, (t_cur * PROBE_SLACK)[:, None], 1.0)
                fq, _ = _tree_feasible(tq.reshape(-1), pinc,
                                       pec.reshape(L * A, d), x, alpha, pch)
                fa = fq.view(L, A) & valid_a
                acc = fa.any(dim=1)
                jstar = fa.to(torch.uint8).argmax(dim=1)
                vnew = palt.gather(1, jstar[:, None])[:, 0]
                parents[:, u] = torch.where(acc, vnew, parents[:, u])
                bm = torch.where(acc[:, None, None], pmask[lidx, jstar], bm)
                ec = torch.where(acc[:, None], pec[lidx, jstar], ec)
                ch = torch.where(acc[:, None, None],
                                 pch.view(L, A, d, d)[lidx, jstar], ch)
                idx = _lanes("local_search.lanes", acc)
                if idx.numel():
                    _, h = _bisect(
                        _tree_oracle(bm[idx, 1:, :], ec[idx], ch[idx], x,
                                     alpha),
                        torch.zeros_like(t_cur[idx]), t_cur[idx], REFINE_ITERS,
                        torch.ones_like(idx, dtype=torch.bool))
                    t_cur = t_cur.index_put((idx,), h)
                improved = improved | acc
                jj = torch.where(acc, jstar + 1, nok)
        if s % d == d - 1:
            running = running & improved
            improved = torch.zeros_like(improved)
            if not _read("local_search.running", running.any())[0]:
                break
    return parents, t_cur


def plan_ftr_batch(caps: torch.Tensor, params: CodeParams,
                   region: Optional[FeasibleRegion] = None,
                   local_search: bool = True,
                   witness: str = "exact", profile=None) -> BatchPlanResult:
    """Algorithm 2 over a batch: the candidate trees (cores of every size
    and the TR tree) with incumbent pruning, the pivot local search from
    the three best, the final 50-step solve on the winner and the level-cut
    witness for its traffic-minimal betas.  ``profile`` times the
    ``tr_seed`` / ``candidates`` / ``local_search`` / ``final_solve`` /
    ``witness`` stages."""
    _check_witness(witness)
    region = _region_for(params, region)
    B, D1, _ = caps.shape
    dev = caps.device
    alpha = params.alpha
    x = torch.tensor(region.x, dtype=F64, device=dev)
    bidx = torch.arange(B, device=dev)
    with _stage(profile, "ftr", "tr_seed", dev):
        tr_parent, _, _ = _tr_greedy(caps, params.beta, alpha)
    with _stage(profile, "ftr", "candidates", dev):
        cands = _ftr_candidates(caps, tr_parent)
        t_cand = _candidate_times(caps, cands, x, alpha)
    order = torch.argsort(t_cand, dim=1, stable=True)
    best_t = t_cand.gather(1, order[:, :1])[:, 0]
    best_par = cands[bidx, order[:, 0]]
    if local_search:
        with _stage(profile, "ftr", "local_search", dev):
            top = order[:, :3]
            par_ls = cands[bidx[:, None], top].reshape(B * 3, D1)
            t_ls = t_cand.gather(1, top).reshape(B * 3)
            par_ls, t_ls = _local_search(caps.repeat_interleave(3, dim=0),
                                         par_ls, t_ls, x, alpha,
                                         torch.isfinite(t_ls))
            par_ls = par_ls.view(B, 3, D1)
            t_ls = t_ls.view(B, 3)
            for s in range(3):              # winner update order: s = 0, 1, 2
                upd = t_ls[:, s] < best_t
                best_t = torch.where(upd, t_ls[:, s], best_t)
                best_par = torch.where(upd[:, None], par_ls[:, s], best_par)
    with _stage(profile, "ftr", "final_solve", dev):
        inc, ec, ch = _tree_arrays(caps, best_par)
        solvable = torch.isfinite(best_t)
        t_star = _tree_optimal_time(inc, ec, ch, x, alpha, FINAL_ITERS,
                                    solvable)
        _, wf = _tree_feasible(torch.where(solvable, t_star, 1.0), inc, ec,
                               x, alpha, ch)
    with _stage(profile, "ftr", "witness", dev):
        betas = torch.where(solvable[:, None], _level_cut(wf, x), 0.0)
    _count(profile, lanes=B, candidate_trees=cands.shape[1],
           final_solve_iters=FINAL_ITERS)
    flows = torch.einsum("bud,bd->bu", inc, betas).clamp_max(alpha)
    et = torch.where(ec > 0, flows / ec, INF)
    return BatchPlanResult(
        "ftr", torch.where(solvable, et.amax(dim=1), INF),
        torch.where(solvable, flows.sum(dim=1), INF), betas, best_par,
        lower_bounds=t_star)
