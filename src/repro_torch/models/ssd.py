"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060): the
counterpart of ``repro.models.ssd``.

The sequence is split into chunks of Q steps; within a chunk the output is
a masked quadratic form, across chunks a small (H, P, N) state is carried
by a loop over the chunks: O(L) work and memory.

Recurrence (per head h, state S in R^{P x N}):
    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,      y_t = S_t C_t + D_h x_t
``ssd_reference`` runs it step by step (the oracle for the tests);
``apply_ssd`` is the chunked equivalent; ``ssd_step`` is the O(1) decode
update.  B and C use a single group shared across heads.

With DTensor inputs (``distributed``) the projections and the gated norm
run through DTensor's sharding propagation, and the causal conv and the
chunked scan run on each device's rows (``batch_local``: their einsums
over the flattened batch and heads have no DTensor rule once both are
sharded), with the scan's small parameters gathered.  The reference's
head hints stand inside the scan, where they act on plain tensors.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..device import DeviceLike
from ..distributed.hints import BATCH, batch_local, gathered, hint
from .config import ModelConfig
from .layers import dt, param


class SSD(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        d, di, N, Hs, conv = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                              cfg.ssm_heads, cfg.ssm_conv)
        self.cfg = cfg
        pd = dt(cfg, "param")
        proj_out = 2 * di + 2 * N + Hs  # z, x, B, C, dt
        self.in_proj = param((d, proj_out), pd, device)
        self.conv_w = param((conv, di + 2 * N), pd, device)
        self.conv_b = param((di + 2 * N,), pd, device)
        self.A_log = param((Hs,), torch.float32, device)
        self.D = param((Hs,), torch.float32, device)
        self.dt_bias = param((Hs,), torch.float32, device)
        self.norm_scale = param((di,), pd, device)
        self.out_proj = param((di, d), pd, device)

    def reset(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        self.in_proj.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
        self.conv_w.normal_(0.0, 0.5, generator=gen)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads,
                                                  dtype=torch.float32)))
        self.D.fill_(1.0)
        self.dt_bias.fill_(-4.6)           # softplus^-1(~0.01)
        self.norm_scale.fill_(1.0)
        self.out_proj.normal_(0.0, 1.0 / math.sqrt(cfg.d_inner), generator=gen)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt_raw = proj[..., di + di + 2 * N:]
    assert dt_raw.shape[-1] == Hs
    return z, xBC, dt_raw


def _causal_conv(cfg: ModelConfig, p: SSD, xBC: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (kernel cfg.ssm_conv) over (B, L, C)."""
    conv = cfg.ssm_conv
    pad = F.pad(xBC, (0, 0, conv - 1, 0))
    L = xBC.shape[1]
    out = torch.zeros_like(xBC, dtype=torch.float32)
    for j in range(conv):
        out = out + pad[:, j:j + L].float() * p.conv_w[j].float()
    out = out + p.conv_b.float()
    return F.silu(out).to(xBC.dtype)


def _gated_out(cfg: ModelConfig, p: SSD, y: torch.Tensor, z: torch.Tensor):
    c = dt(cfg)
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + 1e-6)
    g = g * p.norm_scale.float()
    # out_proj's rows (d_inner) lie on "model": the input to match (on a
    # mesh, a layout DTensor's propagation would not reach by itself)
    return hint(g.to(c), BATCH, *(None,) * (g.dim() - 2), "model") @ \
        p.out_proj.to(c)


def apply_ssd(cfg: ModelConfig, p: SSD, xin: torch.Tensor,
              return_state: bool = False):
    """xin: (B, L, d) -> (B, L, d); L is padded to a chunk multiple inside.

    return_state: also return (conv_state, ssd_state) at the final position
    (the prefill-to-decode handoff)."""
    c = dt(cfg)
    # the projection over the batch: its slices and the scan below are
    # local to a row (left to itself, DTensor may shard the sequence)
    proj = hint(xin.to(c) @ p.in_proj.to(c), BATCH, None, None)
    if isinstance(proj, DTensor):   # the scan on each device's rows
        p_scan = SimpleNamespace(**{n: gathered(getattr(p, n))
                                    for n in _SCAN_PARAMS})
    else:
        p_scan = p
    y, S_prev = batch_local(functools.partial(_scan, cfg, p_scan), proj)
    out = _gated_out(cfg, p, y.to(c), proj[..., :cfg.d_inner])
    if not return_state:
        return out
    return out, (_conv_tail(cfg, proj), S_prev)


_SCAN_PARAMS = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _scan(cfg: ModelConfig, p, proj: torch.Tensor):
    """The causal conv and the chunked scan of ``apply_ssd``: (y (B, L, di)
    before the gate, the final state (B, Hs, P, N))."""
    B, L, _ = proj.shape
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, L)
    Lp = (L + Q - 1) // Q * Q
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC = _causal_conv(cfg, p, xBC)
    x = xBC[..., :di]
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()
    dtv = F.softplus(dt_raw.float() + p.dt_bias.float())      # (B, L, Hs)
    A = -torch.exp(p.A_log)                                     # (Hs,)

    if Lp != L:
        padw = (0, 0, 0, Lp - L)
        x = F.pad(x, padw)
        Bm = F.pad(Bm, padw)
        Cm = F.pad(Cm, padw)
        dtv = F.pad(dtv, padw)  # dt=0 -> exp(0)=1 decay, dt x = 0: inert
    nc = Lp // Q
    xh = hint(x.reshape(B, nc, Q, Hs, P).float(), BATCH, None, None, "model",
              None)
    dtc = hint(dtv.reshape(B, nc, Q, Hs), BATCH, None, None, "model")
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)

    delta = dtc * A                          # (B, nc, Q, Hs), negative
    lam = torch.cumsum(delta, dim=2)         # Λ_t within the chunk
    lam_tot = lam[:, :, -1]                  # (B, nc, Hs)

    # within a chunk: the masked quadratic form
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    decay = torch.exp(lam[:, :, :, None, :] - lam[:, :, None, :, :])
    # (B, nc, Q(t), Q(s), Hs)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=proj.device))
    W = CB[..., None] * torch.where(mask[None, None, :, :, None], decay,
                                    torch.zeros_like(decay))
    W = W * dtc[:, :, None, :, :]            # dt_s
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", W, xh)

    # chunk-final states
    sdecay = torch.exp(lam_tot[:, :, None, :] - lam) * dtc   # (B, nc, Q, Hs)
    S_c = hint(torch.einsum("bcqh,bcqhp,bcqn->bchpn", sdecay, xh, Bc),
               BATCH, None, "model", None, None)

    S_prev = torch.zeros_like(S_c[:, 0])
    y_inter = []
    for i in range(nc):
        # y_inter_t = exp(Lam_t) * C_t . S_prev
        y_inter.append(torch.einsum("bhpn,bqn->bqhp", S_prev, Cc[:, i])
                       * torch.exp(lam[:, i])[..., None])
        S_prev = torch.exp(lam_tot[:, i])[:, :, None, None] * S_prev + S_c[:, i]
    y_inter = torch.stack(y_inter, dim=1)    # (B, nc, Q, Hs, P)

    y = y_intra + y_inter
    y = y + p.D[None, None, None, :, None] * xh
    return y.reshape(B, Lp, di)[:, :L], S_prev


def _conv_tail(cfg: ModelConfig, proj: torch.Tensor) -> torch.Tensor:
    """The last (conv-1) pre-conv xBC rows: the decode-time conv state."""
    _, xBC, _ = _split_proj(cfg, proj)
    return xBC[:, -(cfg.ssm_conv - 1):, :]


def ssd_step(cfg: ModelConfig, p: SSD, xin: torch.Tensor,
             conv_state: torch.Tensor, S: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  xin: (B, 1, d); conv_state: (B, conv-1, di+2N),
    the pre-activation window; S: (B, Hs, P, N).  Returns
    (y, conv_state', S')."""
    B = xin.shape[0]
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    c = dt(cfg)
    proj = xin.to(c) @ p.in_proj.to(c)
    z, xBC_new, dt_raw = _split_proj(cfg, proj)
    wd = torch.promote_types(conv_state.dtype, xBC_new.dtype)
    window = torch.cat([conv_state.to(wd), xBC_new.to(wd)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float()) \
        + p.conv_b.float()
    conv_out = F.silu(conv_out)
    x = conv_out[:, :di].reshape(B, Hs, P)
    Bv = conv_out[:, di:di + N]
    Cv = conv_out[:, di + N:]
    dtv = F.softplus(dt_raw[:, 0].float() + p.dt_bias.float())  # (B, Hs)
    A = -torch.exp(p.A_log)
    a = torch.exp(dtv * A)                                       # (B, Hs)
    S_new = a[:, :, None, None] * S + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, x, Bv.float())
    y = torch.einsum("bhpn,bn->bhp", S_new, Cv.float())
    y = y + p.D[None, :, None] * x
    y = y.reshape(B, 1, di)
    out = _gated_out(cfg, p, y.to(c), z)
    return out, window[:, 1:], S_new


def ssd_reference(cfg: ModelConfig, p: SSD, xin: torch.Tensor) -> torch.Tensor:
    """The sequential recurrence (slow; the oracle for the tests)."""
    B, L, d = xin.shape
    di, N = cfg.d_inner, cfg.ssm_state
    conv_state = torch.zeros((B, cfg.ssm_conv - 1, di + 2 * N), dtype=dt(cfg),
                             device=xin.device)
    S = torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, N),
                    dtype=torch.float32, device=xin.device)
    outs = []
    for t in range(L):
        y, conv_state, S = ssd_step(cfg, p, xin[:, t:t + 1], conv_state, S)
        outs.append(y)
    return torch.cat(outs, dim=1)
