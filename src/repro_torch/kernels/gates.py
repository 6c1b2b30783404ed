"""The hand kernels held to their plain versions on the card: the one home
of each kernel's gates and tolerances.  The kernels' ``chip`` tests
(``tests/test_torch_attention.py``, ``tests/test_torch_optimizer_fused.py``)
and ``chip_smoke.py`` call the same functions here; each draws its
operands, runs the kernel and its plain version on them, raises
``AssertionError`` when a gate fails and returns the readings.  Nothing on
the repair, planning or training paths imports this module.

Attention (``attention_against_plain``): the fused kernel's output and its
dQ, dK and dV against ``chunked_attention``'s and an fp64 dense
attention's, on the same bf16 q, k, v and upstream gradient:

* each output within ``ATTN_ULPS`` = 3 bf16 ulps (of its largest
  magnitude) of the compared version's, element by element: each side's
  worst element lies up to about 1.3 ulp from the fp64 value (1.32 the
  kernel's dQ, 1.09 the plain version's dK at olmo-1b's shape, NVIDIA
  H100), so two sound results differ by up to their sum (2.0 seen).  The
  kernel's dQ has its worst element in the first rows of a causal
  sequence: the plain version's graph also sends the row's sum of dS
  through its max to the argmax score, a term that is zero but for
  rounding and cancels dP's rounding to bf16 in a row of few keys; the
  kernel leaves it out, as FlashAttention does;
* its relative RMS error against the fp64 attention at most
  ``ATTN_RATIO`` = 1.1 times the compared version's: the same precision
  (0.74 to 1.00 times the plain version's seen; the kernel rounds dQ, dK
  and dV once, where the plain version also rounds each query chunk's dK
  and dV to bf16 and sums them in bf16).  The sound errors are about
  2e-3, bf16's rounding of the outputs; one wrong row of 2,048 alone
  reads about 2e-2, ten times that.

And ``attention_repeats``: two backward calls on the same operands give
bitwise-equal dQ, dK and dV (no atomics; nothing depends on the schedule).

AdamW (``adamw_against_plain``): one fused call against the plain update
run at the kernel's clip (the plain version's own fp32 norm differs by an
ulp or so, and near-zero m then differs by millions of ulps): m and v
within 2 fp32 ulps and each parameter within 1 ulp of its dtype (the
arithmetic is the plain version's, operation for operation; ``powf`` may
round the bias corrections otherwise); the norm within 1e-5 relative of
the plain version's (fp32 sums) and 1e-6 of an fp64 norm; two launches
for each group of the chunk map; and a captured replay bitwise the eager
call.

The MoE share's gathers (``moe_gather_against_plain``): the kernels of
``kernels.moe_gather`` against the plain versions of ``models.moe`` on the
same plan, rows and gradients, with the rows of pairs not held set to NaN
(a grouped product leaves them unspecified):

* the combine's ``y``, the dispatch's backward ``gx`` and the combine's
  backward ``gye`` bitwise the plain versions': the same products and
  adds in the same order, each rounded to nearest;
* the combine's ``gg`` within ``GATHER_GG_RTOL`` = 2**-17 of the dot
  product of the absolute values (|gy| . |row|), element by element, of
  the plain version's: a d-term fp32 dot product summed in another order
  (the kernel: 8 FMAs a thread, a warp's shuffles, the warps in order;
  PyTorch: its own reduction tree), each side within about 24 roundings
  of the exact sum, 1.4e-6 of that bound at most (2**-17 is 7.6e-6);
  both sides' errors against an fp64 dot product are recorded;
* one launch a call, and a CUDA graph of the three calls, replayed,
  bitwise the eager calls.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..models import layers
from ..obs import spans
from ..train import optimizer
from . import adamw as kadamw
from . import attention as kattn

BF, F32 = torch.bfloat16, torch.float32
ATTN_ULPS, ATTN_RATIO = 3.0, 1.1
ATTN_NAMES = ("out", "dq", "dk", "dv")
ADAMW_ULPS = dict(m=2.0, v=2.0, p=1.0)
ADAMW_NORM_RTOL, ADAMW_EXACT_RTOL = 1e-5, 1e-6
GATHER_GG_RTOL = 2.0 ** -17


# -- attention ----------------------------------------------------------------

def attention_operands(B: int, S: int, H: int, KV: int, D: int, *,
                       seed: int, device, shuffled: bool = False,
                       qk_norm: bool = False, v_dim: int = None):
    """bf16 q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, ``v_dim``, D
    unless given) and an upstream gradient (B, S, H, ``v_dim``), drawn on
    the CPU from ``seed`` and moved to ``device``, and int32 positions:
    0..S-1, or shuffled.  With ``qk_norm``, q and k are as OLMoE's
    attention makes them: through a weighted RMSNorm over all heads'
    features (scales 1 + 0.1 N(0, 1), eps 1e-5), then RoPE (theta
    10,000)."""
    gen = torch.Generator().manual_seed(seed)
    DV = D if v_dim is None else v_dim

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=F32).to(BF).to(device)

    q, k, v = (normal((B, S, heads, width))
               for heads, width in ((H, D), (KV, D), (KV, DV)))
    g = normal((B, S, H, DV))
    pos = (torch.randperm(S, generator=gen) if shuffled
           else torch.arange(S)).to(device, torch.int32)
    if qk_norm:
        q, k = (layers.rope(layers._qk_norm(x, (1.0 + 0.1 * torch.randn(
            x.shape[2] * D, generator=gen)).to(device, BF), 1e-5), pos, 1e4)
            for x in (q, k))
    return q, k, v, g, pos


def attention_grads(fn: Callable, q, k, v, g) -> List[torch.Tensor]:
    """``fn(q, k, v)`` and its gradients for the upstream ``g``: out, dq,
    dk, dv."""
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(qs, ks, vs)
    out.backward(g)
    return [out.detach(), qs.grad, ks.grad, vs.grad]


def dense_attention64(q, k, v, pos, causal: bool, scale: float = None
                      ) -> torch.Tensor:
    """Dense attention (GQA by repeating KV heads) in the operands' dtype,
    the scores scaled by ``scale`` (1/sqrt of q's width unless given):
    fp64 for the gates' exact reading."""
    G = q.shape[2] // k.shape[2]
    kd = k.repeat_interleave(G, dim=2)
    vd = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kd)
    s = s / math.sqrt(q.shape[-1]) if scale is None else s * scale
    if causal:
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)


def exact_attention(q, k, v, g, pos, causal: bool, scale: float = None
                    ) -> List[torch.Tensor]:
    """out, dq, dk, dv of the fp64 dense attention of the operands."""
    return attention_grads(
        lambda a, b, c: dense_attention64(a, b, c, pos.long(), causal, scale),
        q.double(), k.double(), v.double(), g.double())


def hold_attention(got, want, exact, label: str = ""
                   ) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """Each of ``got``'s out, dQ, dK, dV (bf16) within ``ATTN_ULPS`` bf16
    ulps of the largest magnitude of ``want``'s, element by element, and
    its relative RMS error against ``exact``'s (fp64) at most
    ``ATTN_RATIO`` times ``want``'s.  Returns (the gaps in ulps, [got's,
    want's RMS error]) by name; raises if a gate fails."""
    gaps, rms = {}, {}
    for name, a, b, x in zip(ATTN_NAMES, got, want, exact):
        a, b, x = (t.to(x.device) for t in (a, b, x))
        if a.dtype != BF or a.shape != b.shape:
            raise AssertionError(f"{label} {name}: {a.dtype} {a.shape}, "
                                 f"compared with {b.shape}")
        top = float(b.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        gaps[name] = float((a.float() - b.float()).abs().max()) / ulp
        rms[name] = [float((y.double() - x).norm() / x.norm()) for y in (a, b)]
    bad = [name for name in gaps if not gaps[name] <= ATTN_ULPS
           or not rms[name][0] <= ATTN_RATIO * rms[name][1]]
    if bad:
        raise AssertionError(
            f"{label}: {bad} fail; {gaps} bf16 ulps (gate {ATTN_ULPS}); "
            f"relative RMS errors against fp64, got and compared: {rms} "
            f"(gate {ATTN_RATIO}x the compared version's)")
    return gaps, rms


def attention_against_plain(q, k, v, g, pos, causal: bool, label: str = "",
                            scale: float = None
                            ) -> Tuple[Dict[str, float],
                                       Dict[str, List[float]]]:
    """The fused kernel against ``chunked_attention`` on the card, on the
    same operands (v may be narrower than q and k) and ``scale`` (each
    side's default unless given), by ``hold_attention``'s gates; one
    forward and one backward launch.  Returns ``hold_attention``'s
    readings."""
    launches = [spans.total(f"attn.launches.{x}")
                for x in ("forward", "backward")]
    fused = attention_grads(
        lambda a, b, c: kattn.fused_attention(a, b, c, pos, causal=causal,
                                              scale=scale),
        q, k, v, g)
    plain = attention_grads(lambda a, b, c: layers.chunked_attention(
        a, b, c, causal=causal, q_positions=pos, kv_positions=pos,
        q_chunk=1024, kv_chunk=2048, scale=scale), q, k, v, g)
    torch.cuda.synchronize()
    counted = [spans.total(f"attn.launches.{x}") - n
               for x, n in zip(("forward", "backward"), launches)]
    if counted != [1, 1]:
        raise AssertionError(f"{label}: {counted} forward and backward "
                             "launches, not one of each")
    readings = hold_attention(fused, plain,
                              exact_attention(q, k, v, g, pos, causal, scale),
                              f"kernel against chunked_attention {label}")
    del fused, plain
    torch.cuda.empty_cache()
    return readings


def attention_repeats(q, k, v, g, pos, causal: bool, label: str = "",
                      scale: float = None) -> None:
    """Two calls of the fused kernel's forward and backward on the same
    operands: raises unless the output, dQ, dK and dV are bitwise equal."""
    first, second = (attention_grads(
        lambda a, b, c: kattn.fused_attention(a, b, c, pos, causal=causal,
                                              scale=scale), q, k, v, g)
        for _ in range(2))
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(ATTN_NAMES, first, second)
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{label}: {differ} differ between two calls")


# -- AdamW --------------------------------------------------------------------

def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in ulps of ``want``'s dtype at each element
    of want."""
    exp = torch.frexp(want.float().abs())[1]
    bits = 8 if want.dtype == BF else 24
    ulp = torch.ldexp(torch.ones_like(want, dtype=F32), exp - bits)
    return float(((got.float() - want.float()).abs() / ulp).max())


def adamw_operands(shapes: Sequence, dtypes: Sequence, mdt, gdt, *,
                   seed: int, device, offset: int = 0, on="cpu"):
    """Parameters (``dtypes``), accumulators (``gdt``) and moments
    (``mdt``) of ``shapes`` at step 9, drawn from ``seed`` on the device
    ``on`` and held on ``device``; with ``offset`` each tensor a view that
    starts ``offset`` elements into a larger buffer (not 16-byte
    aligned).  Returns (params, accumulators, ``OptState``)."""
    gen = torch.Generator(on).manual_seed(seed)

    def make(shape, dtype, scale, square=False):
        x = torch.randn(offset + torch.Size(shape).numel(), generator=gen,
                        device=on)
        x = (x * x if square else x) * scale
        return x.to(dtype).to(device)[offset:].view(shape)

    params = {f"w{i}": make(s, d, 0.02) for i, (s, d) in
              enumerate(zip(shapes, dtypes))}
    acc = {n: make(p.shape, gdt, 0.02) for n, p in params.items()}
    state = optimizer.OptState(
        step=torch.full((), 9, dtype=torch.int32, device=device),
        m={n: make(p.shape, mdt, 1e-3) for n, p in params.items()},
        v={n: make(p.shape, mdt, 1e-6, square=True)
           for n, p in params.items()})
    return params, acc, state


def adamw_against_plain(draw: dict, cfg, n_micro: int, label: str = ""
                        ) -> dict:
    """The fused AdamW against the plain update on the card, on operands
    ``adamw_operands(**draw)`` at ``cfg`` (an ``OptimizerConfig``): the
    gates of the module docstring.  At most two draws are alive at once (a
    full configuration's take 18 GB each).  Returns the norms, the clip,
    the launches and the worst ulps of m, v and the parameters."""
    fused = kadamw.FusedAdamW()
    p1, acc, s1 = adamw_operands(**draw)
    launch0 = spans.total("optim.launches")
    norm = optimizer._fused_update(cfg, p1, acc, s1, cfg.lr, n_micro, fused)
    launches = spans.total("optim.launches") - launch0
    # the plain update at the kernel's clip, and the plain norm
    p2, acc2, s2 = adamw_operands(**draw)
    grads = {n: a.float().div_(n_micro) for n, a in acc2.items()}
    clip = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
    optimizer._adamw_update(cfg, p2, grads, s2, cfg.lr, clip)
    plain_norm = float(optimizer.global_norm(list(grads.values())))
    exact_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                      for g in grads.values())))
    gaps = {"m": max(ulps(s1.m[n], s2.m[n]) for n in p1),
            "v": max(ulps(s1.v[n], s2.v[n]) for n in p1),
            "p": max(ulps(p1[n], p2[n]) for n in p1)}
    del p2, acc2, s2, grads
    # a captured replay is bitwise the eager call
    p3, acc3, s3 = adamw_operands(**draw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        norm3 = optimizer._fused_update(cfg, p3, acc3, s3, cfg.lr, n_micro,
                                        fused)
    graph.replay()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(norm3, norm)) and all(
        torch.equal(p3[n], p1[n]) and torch.equal(s3.m[n], s1.m[n])
        and torch.equal(s3.v[n], s1.v[n]) for n in p1)
    rec = dict(launches=launches, norm=float(norm), plain_norm=plain_norm,
               exact_norm=exact_norm, clip=float(clip), ulps=gaps,
               graph_bitwise=bitwise)
    del norm3, graph, p1, acc, s1, p3, acc3, s3
    torch.cuda.empty_cache()
    groups = len(kadamw.chunk_map([math.prod(s) for s in draw["shapes"]]))
    if launches != 2 * groups or \
            abs(rec["norm"] - plain_norm) > ADAMW_NORM_RTOL * plain_norm or \
            abs(rec["norm"] - exact_norm) > ADAMW_EXACT_RTOL * exact_norm or \
            not rec["clip"] < 1.0 or not bitwise or \
            any(gaps[x] > lim for x, lim in ADAMW_ULPS.items()):
        raise AssertionError(
            f"the fused AdamW against the plain update {label}: {rec} "
            f"({2 * groups} launches; gates: ulps {ADAMW_ULPS}, norm "
            f"{ADAMW_NORM_RTOL} of the plain and {ADAMW_EXACT_RTOL} of the "
            "fp64 norm, a clip below 1, a replay bitwise the eager call)")
    return rec


# -- the MoE share's gathers --------------------------------------------------

def moe_gather_operands(T: int, K: int, d: int, experts: int, first: int,
                        held: int, *, seed: int, device, skew: float = 0.0,
                        plan: Callable = None, dtype=BF) -> dict:
    """A share's combine operands, drawn on ``device`` from ``seed``: the
    top ``K`` of ``experts`` router logits of T tokens (N(0, 1) tokens of
    width ``d`` through a router drawn as ``MoE.reset`` draws it, N(0,
    1/d); ``skew`` added to the held experts ``first .. first + held -
    1``' logits), sorted stably as ``MoEShare`` sorts them, their softmax
    probabilities as gates; ``plan(top_ids, first, held)`` (default
    ``models.moe.share_plan``) places the pairs; the rows ``ye`` (R, d) in
    ``dtype``, NaN past the held pairs' rows; the upstream gradient ``gy``
    (T, d) fp32.  Returns the operands and the plan's counts."""
    from ..models import moe
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device=device)
    router = torch.randn((d, experts), generator=gen, device=device) \
        / math.sqrt(d)
    logits = x @ router
    logits[:, first:first + held] += skew
    top = torch.sort(logits, dim=-1, descending=True,
                     stable=True).indices[:, :K]
    gates = torch.gather(torch.softmax(logits, dim=-1), 1, top)
    row, valid, pair, offs, counts = (plan or moe.share_plan)(top, first,
                                                              held)
    ye = torch.randn((pair.shape[0], d), generator=gen, device=device) \
        .to(dtype)
    ye[int(valid.sum()):] = float("nan")
    gy = torch.randn((T, d), generator=gen, device=device)
    return dict(ye=ye, gates=gates, row=row, valid=valid, pair=pair, gy=gy,
                held=int(counts[0]), dropped=int(counts[1]),
                top_held=int(valid.sum(1).max()))


def _gather_calls(ops: dict) -> List[torch.Tensor]:
    """The kernels' three calls: the combine's forward (y), the dispatch's
    backward with ``ye`` in the gradient's place (gx), the combine's
    backward (gye, gg)."""
    from . import moe_gather as kmg
    y = kmg.gather_sum(ops["ye"], ops["row"], ops["valid"], ops["gates"])
    gx = kmg.gather_sum(ops["ye"], ops["row"], ops["valid"],
                        out_dtype=ops["ye"].dtype)
    gye, gg = kmg.combine_backward(ops["gy"], ops["ye"], ops["gates"],
                                   ops["row"], ops["valid"], ops["pair"])
    return [y, gx, gye, gg]


def moe_gather_against_plain(ops: dict, label: str = "") -> dict:
    """The MoE gathers' kernels against the plain versions on the card, on
    ``moe_gather_operands``' ``ops``: the gates of the module docstring.
    Returns the launches, the plan's counts, the bitwise readings and
    ``gg``'s largest gaps over |gy| . |row| (fused against plain, and each
    against fp64)."""
    from ..models import moe
    ye, gy, gates = ops["ye"], ops["gy"], ops["gates"]
    row, valid, pair = ops["row"], ops["valid"], ops["pair"]
    launch0 = spans.total("moe.gather.launches")
    y, gx, gye, gg = fused = _gather_calls(ops)
    launches = spans.total("moe.gather.launches") - launch0
    plain = [moe.gather_sum_plain(ye, row, valid, gates),
             moe.gather_sum_plain(ye, row, valid).to(ye.dtype),
             *moe.combine_backward_plain(gy, ye, gates, row, valid, pair)]
    bitwise = {name: bool(torch.equal(a, b)) for name, a, b in
               zip(("y", "gx", "gye"), fused, plain)}
    finite = all(bool(torch.isfinite(t).all()) for t in fused)
    at = torch.clamp(row, max=ye.shape[0] - 1)
    rows = ye[at].float()
    scale = torch.where(valid, (gy.abs()[:, None] * rows.abs()).sum(-1), 1.0)
    exact = torch.where(valid, (gy.double()[:, None] * rows.double())
                        .sum(-1), 0.0)
    del rows

    def gap(a, b):
        return float(((a.double() - b.double()).abs() / scale).max())
    gg_gaps = dict(plain=gap(gg, plain[3]), fused_exact=gap(gg, exact),
                   plain_exact=gap(plain[3], exact))
    # a captured replay is bitwise the eager calls
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _gather_calls(ops)
    graph.replay()
    torch.cuda.synchronize()
    graph_bitwise = all(torch.equal(a, b) for a, b in zip(replayed, fused))
    captured = spans.total("moe.gather.launches") - launch0 - launches
    rec = dict(held=ops["held"], dropped=ops["dropped"],
               top_held=ops["top_held"], launches=launches,
               captured_launches=captured, bitwise=bitwise, finite=finite,
               gg_gaps=gg_gaps, graph_bitwise=graph_bitwise)
    del graph, replayed, fused, plain, exact, scale
    if launches != 3 or captured != 3 or not all(bitwise.values()) or \
            not finite or gg_gaps["plain"] > GATHER_GG_RTOL or \
            not graph_bitwise:
        raise AssertionError(
            f"the MoE gathers against the plain versions {label}: {rec} "
            f"(gates: 3 launches eager and 3 captured, y, gx and gye "
            f"bitwise, gg within {GATHER_GG_RTOL} of |gy| . |row|, a "
            "replay bitwise the eager calls)")
    return rec
