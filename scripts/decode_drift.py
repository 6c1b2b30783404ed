#!/usr/bin/env python3
"""How far the decode step's logits drift from the parallel forward's with
depth and dtype, on the CPU, in the port and in the JAX reference beside
it: zamba2-7b's layout (ssm layers with a shared attention block every 6,
the SSD chunk of 256) at narrow widths.

    python3 scripts/decode_drift.py [--layers 12 81] [--seed N]

For each depth, in fp32 and in bf16: the reference's weights from
``--seed`` (``repro.models.init_params``, carried into the port with
``from_reference_params``), B = 4 prompts of 128 tokens prefilled, 16
teacher-forced decode steps and the forward over all 144 tokens, each
package on its own cache.  Prints the largest |logit| of each package's
forward and, per position from the prompt's last on, each package's
largest difference from its own forward over that largest |logit|
(``port``, ``reference``), and the port's decode logits' largest
difference from the reference's (``port - reference``).  In fp32 the step
is the forward's; in bf16 the step's rounding departs from the chunked
scan's, more with depth.  This script imports both packages, as the
tests do; the port itself never imports the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as R  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.layers import apply_norm as ref_norm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step, embed_inputs,  # noqa: E402
                                forward_hidden, from_reference_params,
                                init_cache, prefill)

B, S, T = 4, 128, 16
LAYOUT = dict(shared_attn_every=6, ssm_chunk=256, d_model=256, d_ff=512,
              num_heads=8, num_kv_heads=8, head_dim=32, ssm_state=64,
              ssm_head_dim=64, q_chunk=512, kv_chunk=1024, vocab_size=512)


def reference_logits(rcfg, params, toks) -> tuple:
    """The reference's prefill and decode logits (B, T+1, V) and its
    forward's at the same positions, fp32 numpy."""
    rc = R.init_cache(rcfg, B, S + T, dtype=jnp.dtype(rcfg.param_dtype))
    first, rc = jax.jit(lambda p, b, c: R.prefill(rcfg, p, b, c))(
        params, {"tokens": toks[:, :S]}, rc)
    step = jax.jit(lambda p, c, t, pos: R.decode_step(rcfg, p, c, t, pos))
    got = [first]
    for i in range(T):
        logits, rc = step(params, rc, toks[:, S + i:S + i + 1],
                          jnp.int32(S + i))
        got.append(logits)

    @jax.jit
    def forward(p, tokens):
        h = R.embed_inputs(rcfg, p, {"tokens": tokens})
        h, _ = R.forward_hidden(rcfg, p, h, positions=jnp.arange(
            S + T, dtype=jnp.int32))
        h = ref_norm(rcfg, p["final_norm"], h)
        table = p["embed"].get("unembed", p["embed"].get("tok"))
        return h[:, S - 1:].astype(jnp.float32) @ table.astype(jnp.float32).T

    return (np.asarray(jnp.stack(got, axis=1), np.float32),
            np.asarray(forward(params, toks), np.float32))


@torch.no_grad()
def port_logits(cfg, model, toks) -> tuple:
    """The port's prefill and decode logits (B, T+1, V) and its forward's
    at the same positions, fp32 numpy."""
    cache = init_cache(cfg, B, S + T, dtype=getattr(torch, cfg.param_dtype),
                       device="cpu")
    first, _ = prefill(cfg, model, {"tokens": toks[:, :S]}, cache)
    steps = [decode_step(cfg, model, cache, toks[:, S + i:S + i + 1],
                         S + i)[0] for i in range(T)]
    got = torch.stack([first] + steps, dim=1)
    h = embed_inputs(cfg, model, {"tokens": toks})
    h, _ = forward_hidden(cfg, model, h, positions=torch.arange(
        S + T, dtype=torch.int32))
    h = model.final_norm(h)
    want = h[:, S - 1:].float() @ model.embed.table().float().t()
    return got.float().numpy(), want.numpy()


def drift(layers: int, dtype: str, seed: int) -> dict:
    over = dict(LAYOUT, num_layers=layers, param_dtype=dtype,
                compute_dtype=dtype)
    rcfg = dataclasses.replace(ref_smoke("zamba2-7b"), **over)
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"), **over)
    params = jax.jit(R.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(seed))
    model = from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(seed + 8).integers(
        0, cfg.vocab_size, (B, S + T), np.int32)
    ref_got, ref_want = reference_logits(rcfg, params, jnp.asarray(toks))
    got, want = port_logits(cfg, model, torch.from_numpy(toks))
    out = {}
    for name, (a, b) in (("port", (got, want)),
                         ("reference", (ref_got, ref_want)),
                         ("port - reference", (got, ref_got))):
        scale = float(np.abs(b).max())
        out[name] = (scale, (np.abs(a - b).max(axis=(0, 2)) / scale).tolist())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 81])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for layers in args.layers:
        for dtype in ("float32", "bfloat16"):
            for name, (scale, rel) in drift(layers, dtype, args.seed).items():
                print(f"{layers} layers {dtype} {name}: largest |logit| "
                      f"{scale:.3f}; difference / largest by position: "
                      + " ".join(f"{r:.2e}" for r in rel)
                      + f" (max {max(rel):.2e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
