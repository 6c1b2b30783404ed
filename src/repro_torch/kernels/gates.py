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

AdamW (``adamw_against_plain``): one fused call against the plain update
run at the kernel's clip (the plain version's own fp32 norm differs by an
ulp or so, and near-zero m then differs by millions of ulps): m and v
within 2 fp32 ulps and each parameter within 1 ulp of its dtype (the
arithmetic is the plain version's, operation for operation; ``powf`` may
round the bias corrections otherwise); the norm within 1e-5 relative of
the plain version's (fp32 sums) and 1e-6 of an fp64 norm; two launches
for each group of the chunk map; and a captured replay bitwise the eager
call.
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


# -- attention ----------------------------------------------------------------

def attention_operands(B: int, S: int, H: int, KV: int, D: int, *,
                       seed: int, device, shuffled: bool = False,
                       qk_norm: bool = False):
    """bf16 q (B, S, H, D), k and v (B, S, KV, D) and an upstream gradient,
    drawn on the CPU from ``seed`` and moved to ``device``, and int32
    positions: 0..S-1, or shuffled.  With ``qk_norm``, q and k are as
    OLMoE's attention makes them: through a weighted RMSNorm over all
    heads' features (scales 1 + 0.1 N(0, 1), eps 1e-5), then RoPE (theta
    10,000)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=F32).to(BF).to(device)

    q, k, v = (normal((B, S, heads, D)) for heads in (H, KV, KV))
    g = normal((B, S, H, D))
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


def dense_attention64(q, k, v, pos, causal: bool) -> torch.Tensor:
    """Dense attention (GQA by repeating KV heads) in the operands' dtype:
    fp64 for the gates' exact reading."""
    G = q.shape[2] // k.shape[2]
    kd = k.repeat_interleave(G, dim=2)
    vd = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kd) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)


def exact_attention(q, k, v, g, pos, causal: bool) -> List[torch.Tensor]:
    """out, dq, dk, dv of the fp64 dense attention of the operands."""
    return attention_grads(
        lambda a, b, c: dense_attention64(a, b, c, pos.long(), causal),
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


def attention_against_plain(q, k, v, g, pos, causal: bool, label: str = ""
                            ) -> Tuple[Dict[str, float],
                                       Dict[str, List[float]]]:
    """The fused kernel against ``chunked_attention`` on the card, on the
    same operands, by ``hold_attention``'s gates; one forward and one
    backward launch.  Returns ``hold_attention``'s readings."""
    launches = [spans.total(f"attn.launches.{x}")
                for x in ("forward", "backward")]
    fused = attention_grads(
        lambda a, b, c: kattn.fused_attention(a, b, c, pos, causal=causal),
        q, k, v, g)
    plain = attention_grads(lambda a, b, c: layers.chunked_attention(
        a, b, c, causal=causal, q_positions=pos, kv_positions=pos,
        q_chunk=1024, kv_chunk=2048), q, k, v, g)
    torch.cuda.synchronize()
    counted = [spans.total(f"attn.launches.{x}") - n
               for x, n in zip(("forward", "backward"), launches)]
    if counted != [1, 1]:
        raise AssertionError(f"{label}: {counted} forward and backward "
                             "launches, not one of each")
    readings = hold_attention(fused, plain,
                              exact_attention(q, k, v, g, pos, causal),
                              f"kernel against chunked_attention {label}")
    del fused, plain
    torch.cuda.empty_cache()
    return readings


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
