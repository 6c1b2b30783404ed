#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

What it does, in order; any failed check raises and the exit code is
nonzero:

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, then builds the GF(2^8) matmul kernel (bit-matrix
   ``wgmma``) from ``src/repro_torch/kernels/csrc/gf_matmul.cu`` for sm_90a
   and prints ptxas's registers and spills.
2. The main path, at the paper's Fig. 7 deployment (arXiv:1603.05163 §VI:
   MSR n=20, k=5, d=10) with the file cut into M = 240 blocks of 4 MiB
   (960 MiB; alpha = 48, beta = 8): the file is distributed onto 20 nodes
   on the card, then one node is failed and repaired with each of star,
   fr, tr and ftr in turn.  Each repair samples a U[10,120] overlay, plans
   it on the card through the planning tier (the simulator's default
   ``engine="batched"``) and runs the plan through the kernel; the file is then
   decoded from the newcomer plus k-1 other nodes and must equal the
   original bit for bit; the same repair re-run from the same random
   state with the plain PyTorch matmul on the card must give the same
   newcomer; and 64 sampled k-subsets must reconstruct.  The kernel's
   launch counter is zeroed before this phase and must have risen after.
3. The kernel against its plain version on the card (``torch.equal``):
   mapping probes (``mapping_probes``: the identity with single-bit
   payloads at K = 1..5 and 1024 and N = 1000..1008, every N % 8; single
   set bits in a zero payload at the tile edges and the last column; K =
   1024 in chunks at odd N; M = 9..11 at odd N; a payload 1..7 bytes off
   alignment), ragged shapes, zeros, the
   identity and every product shape the main path ran; the plain
   bit-matrix version against the plain version.  Then times of both at
   each main-path shape beside the card's bound for that work, and at the
   distribute and decode shapes ``torch._int_mm`` (cuBLASLt) on the
   kernel's own bit-matrix product as a yardstick (``int8_gemm_ms``).  The
   kernel's ``ms`` in the record is the main path's own launches, timed by
   CUDA events around each call.
   Then the fused attention kernel (``attention_phase``,
   ``src/repro_torch/kernels/csrc/attention.cu``; ``scripts/
   attention_phase.py`` runs it alone): built for olmo-1b's head dim
   (causal; ptxas's registers printed), held to ``chunked_attention`` on
   the card at olmo-1b's microbatch (2 x 2,048 x 16 heads x 128: output,
   dQ, dK, dV within 3 bf16 ulps of each one's largest magnitude, and
   each one's relative RMS error against an fp64 attention at most 1.1
   times the plain version's), and timed a call forward and backward by
   CUDA events beside the bound (the causal products' FLOPs at 989e12),
   ``chunked_attention`` and PyTorch's ``scaled_dot_product_attention``
   (a yardstick the port never calls).  Its record joins the ``kernels``
   list; phase 7b fills in the main path's part (``attention_main_path``:
   the launches and calls counted in a profiled eager olmo-1b step, and
   the kernel's device ms in a profiled replay).
4. Bulk planning on the card: ``plan_many`` with the planning tier
   (``repro_torch.core.torch_engine``) at the paper's deployments (Fig. 7:
   MSR n=20 k=5 d=10, B=4096; Fig. 8: the interior point halfway from MSR
   to MBR, B=4096; Fig. 6: d=19, B=1024; and 300 overlays of fan-outs
   5..19, bucketed by d), caps U[10,120] drawn from ``--seed`` and copied
   to the card at once.  For each run and scheme: cold and warm wall
   times (ending in a synchronize), plans per second, the engine's own
   device reads, the warm time with plain bisection (one midpoint per
   oracle call) beside the speculative one, and 256 lanes chosen by the
   seed (every lane for star) held against the scalar planners on the
   host: parents equal, star times bitwise, the rest within 1e-9 relative;
   a lane whose tree differs passes only if both trees take the same time
   within 1e-9 (a tie), and ties are counted.  Then the repair latency of
   phase 2 in its steady state: 16 Fig. 7 overlays planned one at a time
   (B = 1) on the card after a warm-up call, each held to and timed beside
   the scalar planner on the host on the same overlay (run ``fig7-b1``).

5. The fleet (``repro_torch.fleet``) on the card, every simulator built with
   the card as its device, so each repair epoch is planned there through
   ``plan_many`` and the data plane's store is held there:

   a. the 4 rows of ``benchmarks/golden/fleet_quick_seed0.json`` (the
      reference's quick sweep, ``benchmarks/fleet_scale.py:164-220``;
      msr n=12 k=3 d=6 M=600) re-simulated at the default engine: counts
      equal, floats within 1e-9 relative (a plan-error key, a ratio less
      one of about 1e-16, within 16 ulp of the ratio; ROADMAP C6);
   b. region scale with the coded data plane: ``hot_reads`` at n = 96
      under fleet_scale's storm (shocks every duration/8 down to 0.35),
      about 150 failures, decode checks on, 4 MiB a block, so the store
      holds 96 nodes x 2 blocks x 4 MiB = 768 MiB on the card.  Every
      repair's decode check must pass, reads must complete, the kernel's
      launch counter (zeroed before the run) must have risen and equal
      the store's products; the same run with the store's products on the
      plain version on the card (the planning calls answered from the
      first run's record, each checked to see the same overlays) must
      leave bitwise equal stores and an equal summary; and the run traced
      (planned again) must give an equal summary.  The kernel is then held
      to the plain version at each product shape of the run and timed
      beside its bound;
   c. the ``ensemble_n96_K4_star`` row (``benchmarks/fleet_scale.py:143-
      149``: 4 clusters of 96 nodes in lockstep, 600 s, slow U[0.3, 8]
      links) planned on the card, held to the same ensemble planned by the
      scalar engine, and at ``--seed 0`` to the reference's numbers in
      ``BENCH_fleet.json``: pooled summary and bootstrap intervals.

   Each run records its wall time, events per second, the time spent in
   policy calls (ending in a synchronize) and its share of the wall, the
   planning batch sizes per epoch, and peak device memory.

6. Checkpoint regeneration and the LM stack at full width, on the card
   (``repro_torch.ft``, ``repro_torch.models``), as the reference's
   walkthrough does it (``examples/regenerate_checkpoint.py:20-28``) but at
   yi-6b's published width:

   a. yi-6b (bf16, 6,061,035,520 parameters, 12.1 GB) drawn on the card
      from ``--seed``; the state ``{"params", "step"}`` saved as an
      ``ErasureCoder(n=8, k=4, d=6, blocks_per_host=16)`` checkpoint over
      hosts 0-3 and 8-11 of a 2-pod fleet (M = 64 blocks of 189,407,361
      bytes, 128 coded blocks: 24.2 GB on the card).  Host 9 then fails
      five times, regenerated each time with star, fr, tr, ftr and auto in
      turn; after each, the state is restored from a set of k hosts with
      host 9 and from one without, and every leaf must equal the original
      byte for byte.  Every coded product goes through the kernel (its
      launch counter, zeroed first, must rise); afterwards the kernel is
      held to the plain version at every product shape of the phase on
      fresh operands at the full width, on column windows (the first and
      the last 4 MiB, which holds the ragged tail), and timed beside its
      bound and, where N is odd (the shifted variant), beside the aligned
      variant at N rounded down to a multiple of 8 (``aligned_ms``).
   b. yi-6b prefill (B = 1, S = 2048) and 16 teacher-forced decode steps,
      each run twice in turns (which goes first alternates a step): by
      eager ``decode_step`` (an int position, copied to the card each
      step) on the prefilled cache, and
      by a ``serve.DecodeGraph`` (the step captured as a CUDA graph, its
      position a device tensor) over a copy of that cache.  Each step's
      graph logits must equal the eager ones bitwise or within one bf16
      ulp of the step's largest |logit| (whether they were bitwise equal
      is recorded); both paths' logits are finite and equal the parallel
      forward's at their positions within 5 % of the largest logit (bf16
      over 32 layers); layer 0's chunked attention equals a dense fp32
      attention on the same q, k and v within 2e-2 absolute plus 2e-2
      relative (bf16 rounds the probabilities and the output).

   It records the state's bytes, save, plan, execute and restore times
   (host clock ending in a synchronize), kernel launches and ms (CUDA
   events around each product), blocks moved against M, each scheme's
   predicted time, prefill times, and peak memory above the phase's
   baseline; for the decode steps, each path's ms a step (host clock to
   a synchronize, and CUDA events around the step or the replay), the
   graph's build (three warm-up steps and the capture) and capture ms,
   the kernels of one eager step and of one replay with the five taking
   the most device time (``torch.profiler``), and the step's bytes bound
   (the parameters it reads, the cache, the logits, over HBM).

   b'. (run after 7a, one model on the card at a time) the same
      eager-against-graph check, gates and records at the moe and hybrid
      families' full width, random weights from ``--seed``: olmoe-1b-7b
      (64 experts, top 8; the bound counts only the experts a step routes
      to) and zamba2-7b (81 ssm layers and 13 shared-attention
      applications), B = 4, prompts of 128 tokens, 16 steps; both paths'
      gap to the parallel forward is recorded.  Then the same cell with
      fp32 weights, where bf16's rounding cannot hide a fault in the step
      (over 81 layers it drifts to about 5-7 % of the largest logit; in
      fp32 the step is the forward's to within ``FP32_LOGIT_TOL``): graph
      against eager as above, and both paths' logits within 1e-3 of the
      forward's largest |logit|.  olmoe's prefill and forward run with
      room in every expert for every pair of a row, so they drop none, as
      the decode step (one token a row) never does.  Then the graph
      against eager at every causal smoke config in bf16 (dense, moe,
      ssm, hybrid, vlm: B = 2, prompts of 12, 16 steps), so that each
      family's step is captured and replayed on the card.

7. Serving and training on the card (``repro_torch.serve``,
   ``repro_torch.train``):

   a. phase 6's yi-6b behind ``ServeEngine(slots=4, max_len=1024)``: 6
      requests (more than the slots, so the queue refills) with prompts of
      64 to 512 tokens, mixed so that prompts are left-padded, 32 new
      tokens each, 4 greedy and 2 at temperature 0.8.  The completions must
      have the right ids, lengths and token range; each greedy token's
      logit in the parallel forward over the same padded sequence must be
      within 5 % of the largest |logit| of the forward's largest logit (the
      gate of 6b).  On the card every decode step replays the engine's
      one CUDA graph of 4 rows (the second chunk's 2 requests decode in it
      beside 2 spare rows); the number of replays must equal the decode
      steps, the decoder must be that graph, and it must be built once an
      engine.  The same engine serves the requests again with its sampler
      reseeded (its graph and cache reused), and a second engine with the
      same seed serves them; both must give the same tokens.  Records
      prefill ms per chunk, decode ms per step (host clock around each
      replay to a synchronize), tokens/s with the capture in the wall and
      with the graph reused, the graph's build and capture ms, the kernels
      of one replay and the step's bytes bound, peak memory allocated, and
      the memory the allocator holds (``memory_reserved``) before the
      phase and after each run, the graph's private pool included.
   b. ``train`` on olmo-1b at its published width (1,279,787,008 bf16
      parameters, AdamW with fp32 moments and an fp32 accumulator, the
      reference's dtype policy): batches of 4 x 2048 tokens in 2
      microbatches, 8 steps, an n=8 k=4 d=6 checkpoint (16 blocks a host)
      every 4 steps, once uninterrupted and once with host 3 failing after
      step 5, regenerated with FTR through the kernel and restored.  Every
      loss must be finite; the decoded state must equal the saved bytes;
      the replayed losses must equal the uninterrupted run's within rtol
      1e-5 (whether they and the final parameters are bitwise equal is
      recorded, with the parameters whose gradients differ between two
      backward passes of one microbatch, with and without
      ``torch.use_deterministic_algorithms``); the kernel's launch counter,
      zeroed first, must rise and equal the products; afterwards the kernel
      is held to the plain version at every product shape of the phase on
      column windows, as in 6a.  Every step of both runs goes through the
      loop's one ``train.TrainGraph``: the first eagerly (the capture's
      warm-up), every later one as a replay of the step captured as a
      CUDA graph (released before each save and before the regeneration
      and restore, captured again at the next step); the run must build
      one graph and call it once a step.  Records every call's time (and
      the replays', the eager first calls' and the capture calls' apart),
      each run's stepping time beside an eager loop's at the gates' step
      times, what a capture costs over a replay and a replay saves over
      an eager step, save, plan, execute and restore times (host clock
      ending in a synchronize), kernel launches and ms (CUDA events), and
      peak memory above the phase's baseline.  Then, at fresh weights
      from ``--seed`` and the same batches, 3 steps each eagerly with the
      plain fp32 products (the selection of ``layers.fp32_product``
      patched to refuse the card version), eagerly with the products on
      the tensor cores (``train.EagerTrainStep``) and through a
      ``TrainGraph`` (eager, capture, replay): the graph's losses and
      grad norms must be the eager step's within rtol 1e-5 (whether
      bitwise is recorded); the tensor-core step's first loss within 1/4
      bf16 ulp of the fp32 products' (the CPU test's loss gate,
      ``tests/test_torch_bf16.py``) and its losses and grad norms within
      rtol 1e-3 of theirs at every step; step ms, tokens/s, peak and
      reserved GiB, the graph's capture ms, and one more step of each
      profiled (``step_profile``: device ms by category, kernels, the
      device's idle share of the call) are recorded.

8. Sharding (``repro_torch.distributed``, ``repro_torch.launch``):

   a. olmo-1b's train step at phase 7b's width, batch and microbatches
      (fresh weights from ``--seed``, AdamW with fp32 moments), 3 steps
      each: plain; with its bf16 parameters placed by
      ``param_shardings(fsdp=True)`` on ``make_host_mesh()`` (1x1, NCCL
      at world size 1) and ``grad_shardings``; and with
      ``gather_weights_once`` as well.  The losses and grad norms must
      equal the plain step's within rtol 1e-5 and every final parameter
      within 1e-5 of its largest |value|; whether they are bitwise equal,
      the median step ms of each run (host clock to a synchronize; the
      gap to the plain step is DTensor's host dispatch) and the peak GiB
      are recorded.
   b. meanwhile, on the host, ``python -m repro_torch.launch.dryrun`` for
      yi-6b x train_4k at 16x16 and at 2x16x16 (two processes at once;
      meta tensors, a fake process group, no CUDA context): each cell must
      be ``ok``, its argument bytes must equal their sum by arithmetic on
      the specs, its counted FLOPs must be at least
      ``model_flops_per_device``, every roofline term must be finite, and
      it must not have opened a CUDA context.  Records memory, FLOPs,
      collectives and the H100 roofline per cell.

The lines before the last are the ``{"planning": [...]}``, ``{"fleet":
[...]}``, ``{"ft": {...}}`` (6b' under ``"lm_graphs"``: ``"full"`` and ``"smoke"``), ``{"train":
{...}}``, ``{"shard": {...}}``
and ``{"kernels": [...]}`` records (the kernel's entry carries its fleet-path,
checkpoint-path and train-path launches, times and shapes under
``"fleet"``, ``"ft"`` and ``"train"``); the last line is ``{"ok": true,
"device": {...}}``.  Without CUDA it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import random
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

DEVICE = "cuda"
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_MACS_PER_S = 1979e12 / 2      # H100 SXM dense int8 tensor cores
PARAMS = dict(n=20, k=5, d=10, M=240.0)
BLOCK_BYTES = 4 * MIB
SCHEMES = ("star", "fr", "tr", "ftr")
PROB_SAMPLES = 64
INT8_CHUNK = 1 << 16             # payload columns per torch._int_mm call
# phase 4: (run, n, k, d or None for ragged, alpha: "msr" or "interior",
# batch, schemes, source of the deployment)
PLAN_RUNS = [
    ("fig7-msr", 20, 5, 10, "msr", 4096,
     ("star", "fr", "tr", "ftr", "shah"), "benchmarks/fig7_bandwidth.py:14"),
    ("fig8-interior", 20, 5, 10, "interior", 4096,
     ("star", "fr", "tr", "ftr", "shah"), "benchmarks/fig8_alpha.py:15,35"),
    ("fig6-d19", 20, 5, 19, "msr", 1024,
     ("star", "fr", "tr", "ftr", "shah"), "benchmarks/fig6_d_sweep.py:16"),
    ("ragged", 20, 5, None, "msr", 300, ("fr", "ftr"),
     "src/repro/core/api.py:410"),
]
PLAN_M = 8000.0
PLAN_CHECK = 256                 # lanes held against the scalar planners
B1_OVERLAYS = 16                 # overlays planned one at a time (fig7-b1)
REL_TOL = 1e-9
PLAN_ERR_TOL = 16 * sys.float_info.epsilon   # plan-error keys, on the ratio
# phase 5: the fleet.  fleet_scale's code (benchmarks/fleet_scale.py:160-161)
FLEET_PARAMS = dict(n=12, k=3, d=6, M=600.0)
FLEET_GOLDEN = "benchmarks/golden/fleet_quick_seed0.json"
FLEET_BENCH = "BENCH_fleet.json"          # the reference's full sweep, seed 0
FLEET_EVENTS = 150                        # fleet_scale.py:93, EVENT_BUDGET
REGION_N, REGION_LAM = 96, 2e-3
REGION_PAYLOAD = BLOCK_BYTES              # the main path's block size
FLEET_EPOCHS = 16                         # storm epochs re-planned, timed
ENSEMBLE_ROW = "ensemble_n96_K4_star"     # fleet_scale.py:143-149
ENSEMBLE_CI_KEYS = ("mean_backlog", "regen_p50", "regen_p99",
                    "vulnerability_p99", "unavail_fraction",
                    "mttdl_estimate")
# phase 6: the reference's walkthrough (examples/regenerate_checkpoint.py:
# 20-28) at yi-6b's full width
FT_ARCH = "yi-6b"
FT_CODER = dict(n=8, k=4, d=6, blocks_per_host=16)
FT_FLEET = dict(num_pods=2, hosts_per_pod=8, straggler_fraction=0.2)
FT_HOSTS = [0, 1, 2, 3, 8, 9, 10, 11]
FT_FAILED = 9
FT_SCHEMES = ("star", "fr", "tr", "ftr", "auto")
FT_WINDOW = 4 * MIB                       # payload columns held to plain
LM_PROMPT, LM_DECODE = 2048, 16
LM_LOGIT_TOL = 5e-2                       # of the largest |logit|
# 6b': the captured decode step at the moe and hybrid families' full width
GRAPH_ARCHS = ("olmoe-1b-7b", "zamba2-7b")
GRAPH_BATCH, GRAPH_PROMPT = 4, 128
SMOKE_PROMPT = 12                         # 6b' at every causal smoke config
FP32_LOGIT_TOL = 1e-3                     # 6b' with fp32 weights
ATTN_TOL = 2e-2                           # absolute and relative
# phase 7: serving at yi-6b (phase 6's model), training olmo-1b at its
# published width (src/repro/configs/olmo_1b.py:6-10) with a host failure
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 1024, 32
SERVE_REQUESTS = [(512, 0.0), (64, 0.0), (300, 0.8), (200, 0.0),
                  (448, 0.8), (96, 0.0)]  # (prompt tokens, temperature)
TRAIN_ARCH = "olmo-1b"
TRAIN_DATA = dict(batch=4, seq_len=2048)
TRAIN_LOOP = dict(steps=8, ckpt_every=4, n_micro=2, ec_n=8, ec_k=4, ec_d=6,
                  blocks_per_host=16)
TRAIN_FAIL = {5: 3}                       # host 3 fails after step 5
TRAIN_RTOL = 1e-5                         # replayed losses, the reference's
GATE_STEPS = 3                            # graph/eager, tensor cores/fp32
PRODUCT_ULPS = 0.25                       # tests/test_torch_bf16.py's loss
PRODUCT_RTOL = 1e-3                       # every loss and grad norm (seen:
                                          # 8.2e-6, grad norms to 2.4e-4)
# phase 8: sharding.  8a: olmo-1b's train step on a 1x1 mesh (phase 7b's
# model, batch and microbatches); 8b: the dry run of yi-6b x train_4k at
# 16x16 and 2x16x16 on the host (the other cells, kimi-k2's among them, by
# hand: ``python -m repro_torch.launch.dryrun --all``, PERF.md)
ATTN_SHAPE = dict(B=2, S=2048, H=16, KV=16, D=128)   # olmo-1b's microbatch
ATTN_REPS = 20
ATTN_ULPS, ATTN_RATIO = 3.0, 1.1  # tests/test_torch_attention.py's gates
ATTN_COUNTERS = ("attn.fused", "attn.chunked", "attn.launches.forward",
                 "attn.launches.backward")
BF16_FLOPS_PER_S = 989e12         # H100 SXM, dense
SHARD_STEPS = 3
SHARD_RTOL = 1e-5                         # phase 7b's replay gate
DRYRUN_CELLS = [("yi-6b", "train_4k", False), ("yi-6b", "train_4k", True)]
DRYRUN_TIMEOUT = 600


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_terms(m: int, k: int, n: int):
    """(bytes ms, operations ms) of one (M, K, N) GF(2^8) product on the
    card: each operand read once and the output written once over HBM, and
    64 bit-plane int8 MACs per field product over the tensor cores.  The
    bound is the larger of the two."""
    return ((m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3,
            64 * m * k * n / INT8_MACS_PER_S * 1e3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int8_gemm_ms(a: torch.Tensor, n: int, gen) -> float:
    """Device ms of ``torch._int_mm`` (cuBLASLt) on the kernel's own
    bit-matrix product for A (M, K) and an (K, n) payload: B_bits^T
    (INT8_CHUNK x 8K) int8 times T^T (8K x 8M) int8, timed on one column
    chunk and scaled by n / INT8_CHUNK.  The packed parity of its counts
    must equal the kernel's product on that chunk."""
    from repro_torch.kernels import gf_bitmatrix, gf_matmul_cuda

    m, kk = a.shape
    t_t = gf_bitmatrix(a).to(torch.int8).t()              # (8K, 8M)
    bc = rand_u8((kk, INT8_CHUNK), gen)
    shifts = torch.arange(8, device=DEVICE, dtype=torch.int32)
    bbits = ((bc.to(torch.int32).unsqueeze(1) >> shifts.view(1, 8, 1)) & 1) \
        .reshape(8 * kk, INT8_CHUNK).t().contiguous().to(torch.int8)
    ms = cuda_ms(lambda: torch._int_mm(bbits, t_t), 3) * n / INT8_CHUNK
    bits = (torch._int_mm(bbits, t_t) & 1).view(INT8_CHUNK, m, 8)
    packed = (bits << shifts).sum(dim=-1).to(torch.uint8).t()
    if not torch.equal(packed, gf_matmul_cuda(a, bc)):
        raise AssertionError(f"int8 GEMM parity != kernel at M={m}, K={kk}")
    return ms


class ShapeLog:
    """A GF matmul that records the (M, K, N) of every call, brackets the
    call with CUDA events on the current stream, and passes it on unchanged
    (here: to the port's dispatcher, i.e. the kernel).  The output's memory
    is taken from the allocator before the start event and freed at once,
    so the wrapper's own allocation reuses it and the events hold the
    launch, not the allocator mapping new memory."""

    def __init__(self, matmul):
        self.matmul = matmul
        self.shapes = collections.Counter()
        self.events = []          # [((M, K, N), start, end), ...]

    def __call__(self, a, b):
        shape = (a.shape[0], a.shape[1], b.shape[1])
        self.shapes[shape] += 1
        torch.empty(shape[0] * shape[2], dtype=torch.uint8, device=a.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.matmul(a, b)
        end.record()
        self.events.append((shape, start, end))
        return out

    def ms_by_shape(self):
        """Device ms between each call's events, summed per shape (call
        after a synchronize)."""
        total = collections.Counter()
        for shape, start, end in self.events:
            total[shape] += start.elapsed_time(end)
        return total


def rand_u8(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE,
                         generator=gen)


def rel_ok(got: float, want: float) -> bool:
    """Equal within 1e-9 relative (1e-9 absolute below 1); infinities
    only as themselves."""
    if math.isinf(got) or math.isinf(want):
        return got == want
    return abs(got - want) <= REL_TOL * max(1.0, abs(want))


def rel_err(got: float, want: float) -> float:
    if math.isinf(got) or math.isinf(want):
        return 0.0 if got == want else math.inf
    return abs(got - want) / max(1.0, abs(want))


def plan_params(core, n: int, k: int, d: int, point: str):
    """MSR, or the interior point halfway from MSR to MBR (Fig. 8)."""
    if point == "msr":
        return core.CodeParams.msr(n=n, k=k, d=d, M=PLAN_M)
    a_msr = PLAN_M / k
    a_mbr, _ = core.mbr_point(PLAN_M, k, d)
    return core.CodeParams(n=n, k=k, d=d, M=PLAN_M,
                           alpha=a_msr + 0.5 * (a_mbr - a_msr))


def draw_caps(rng: np.random.Generator, B: int, d: int) -> np.ndarray:
    """B overlays of d providers, links U[10,120] (Fig. 7's uniform)."""
    caps = rng.uniform(10.0, 120.0, size=(B, d + 1, d + 1))
    idx = np.arange(d + 1)
    caps[:, idx, idx] = 0.0
    return caps


def check_lanes(core, scheme: str, res, nets, params_of, lanes) -> dict:
    """Hold the lanes ``lanes`` of the card's batch ``res`` against the
    scalar planners on the host, under the cross-engine contract; raise on
    the first lane that breaks it.  A lane whose tree differs is a tie only
    if both trees take the same time within 1e-9 (the scheme's own time of
    a tree: ``tree_time_uniform`` for tr, ``eval_tree`` for ftr)."""
    host = {f: getattr(res, f).cpu() for f in
            ("times", "traffic", "betas", "parents")}
    host["lower_bounds"] = (None if res.lower_bounds is None
                            else res.lower_bounds.cpu())
    plans = core.plans_from_batch(res, params_of(0))
    ties, max_err, scalar_s = [], 0.0, 0.0
    for b in lanes:
        net, pb = nets[b], params_of(b)
        d = net.d
        t0 = time.perf_counter()
        ps = core.plan(net, pb, scheme, engine="scalar")
        scalar_s += time.perf_counter() - t0
        got_t = float(host["times"][b])
        parent = {u: int(host["parents"][b, u]) for u in range(1, d + 1)}
        if parent != ps.parent:
            if scheme == "tr":
                a = core.tree_time_uniform(parent, net, pb)
                w = core.tree_time_uniform(ps.parent, net, pb)
            elif scheme == "ftr":
                region = (core.msr_region(pb) if pb.is_msr
                          else core.heuristic_region(pb))
                a = core.eval_tree(parent, net, pb, region, iters=50)[0]
                w = core.eval_tree(ps.parent, net, pb, region, iters=50)[0]
            else:
                raise AssertionError(f"{scheme} lane {b}: star parents")
            if not (rel_ok(a, w) and rel_ok(got_t, ps.time)):
                raise AssertionError(
                    f"{scheme} lane {b}: tree {parent} takes {a}, the "
                    f"scalar tree {ps.parent} {w}; times {got_t} vs "
                    f"{ps.time}")
            ties.append(b)
            continue
        if scheme == "star" and got_t != ps.time:
            raise AssertionError(f"star lane {b}: {got_t} != {ps.time}")
        pairs = [(got_t, ps.time),
                 (float(host["traffic"][b]), ps.total_traffic)]
        pairs += list(zip(host["betas"][b, :d].tolist(), ps.betas))
        if ps.lower_bound is not None:
            pairs.append((float(host["lower_bounds"][b]), ps.lower_bound))
        for g, w in pairs:
            max_err = max(max_err, rel_err(g, w))
            if not rel_ok(g, w):
                raise AssertionError(f"{scheme} lane {b}: {g} vs {w}")
        plans[b].validate(net)
    return dict(lanes_checked=len(lanes), tie_lanes=len(ties), ties=ties,
                max_rel_err=max_err,
                scalar_ms_per_plan=scalar_s / len(lanes) * 1e3)


def attention_flops(B: int, S: int, H: int, D: int, causal: bool):
    """(forward, backward) FLOPs of attention over B x H sequences of S at
    head dim D: 2 D multiply-adds a (query, key) pair a product, over the
    pairs the mask keeps (S (S + 1) / 2 causal); the forward's products
    are QK^T and PV, the backward's dP, dV, dK and dQ (P recomputed is
    not counted)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    product = 2 * B * H * pairs * D
    return 2 * product, 4 * product


def attention_phase(seed: int) -> dict:
    """The fused attention kernel alone at olmo-1b's microbatch
    (``ATTN_SHAPE``, causal, random bf16 q, k, v and upstream gradient from
    ``seed``): its build and ptxas report; its output and dQ, dK, dV
    against ``chunked_attention``'s on the card by the card tests' two
    gates (within ``ATTN_ULPS`` bf16 ulps of each one's largest magnitude,
    and a relative RMS error against an fp64 attention at most
    ``ATTN_RATIO`` times the plain version's); then the forward (with the
    records its backward keeps) and the backward (``torch.autograd.
    grad``), each timed a call by CUDA events over ``ATTN_REPS`` calls,
    beside the bound (``attention_flops`` at the bf16 peak),
    ``chunked_attention`` (the plain version) and
    ``scaled_dot_product_attention`` (the library's yardstick, which the
    port never calls).  A train step's totals come from the main path
    (``attention_main_path``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention as kattn
    from repro_torch.models.layers import chunked_attention
    from repro_torch.obs import spans

    B, S, H, KV, D = (ATTN_SHAPE[x] for x in ("B", "S", "H", "KV", "D"))
    t0 = time.perf_counter()
    path, out = kattn.build(D, True)
    kattn.library(D, True)
    build_s = time.perf_counter() - t0
    log(f"attention kernel: build {build_s:.2f} s -> {path.name}")
    for line in out.splitlines():
        if any(w in line for w in ("registers", "spill", "smem")):
            log("  ptxas:", line.strip())

    dev = torch.device(DEVICE, torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(heads):
        return torch.randn((B, S, heads, D), generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)

    q, k, v = draw(H), draw(KV), draw(KV)
    g = torch.randn((B, S, H, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    routes = {
        "kernel": lambda: kattn.fused_attention(q, k, v, pos, causal=True),
        "plain": lambda: chunked_attention(
            q, k, v, causal=True, q_positions=pos, kv_positions=pos,
            q_chunk=1024, kv_chunk=2048),
        "library": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)}

    def grads(fn, operands=(q, k, v), grad=g):
        out = fn(*operands)
        return [out.detach()] + list(torch.autograd.grad(out, operands, grad))

    def dense64(a, b, c):
        s = torch.einsum("bqhd,bkhd->bhqk", a, b) / math.sqrt(D)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), c)

    names = ("out", "dq", "dk", "dv")
    fused = grads(lambda *x: routes["kernel"]())
    plain = grads(lambda *x: routes["plain"]())
    ops64 = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    exact = grads(dense64, ops64, g.double())
    del ops64
    gaps, rms = {}, {}
    for name, a, b, x in zip(names, fused, plain, exact):
        ulp = bf16_ulp(float(b.float().abs().max()))
        gaps[name] = float((a.float() - b.float()).abs().max()) / ulp
        rms[name] = [float((y.double() - x).norm() / x.norm())
                     for y in (a, b)]
    del fused, plain, exact
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, gaps.values())) or \
            max(gaps.values()) > ATTN_ULPS or \
            any(not ka <= ATTN_RATIO * pa for ka, pa in rms.values()):
        raise AssertionError(
            f"kernel against chunked_attention: {gaps} bf16 ulps (gate "
            f"{ATTN_ULPS}); relative RMS errors against fp64, kernel and "
            f"plain: {rms} (gate {ATTN_RATIO}x the plain version's)")
    log("  kernel against chunked_attention: "
        + ", ".join(f"{n} {x:.2f}" for n, x in gaps.items())
        + " bf16 ulps of the largest magnitude; relative RMS error against "
        "fp64, kernel / plain: " + ", ".join(
            f"{n} {ka:.3e} / {pa:.3e}" for n, (ka, pa) in rms.items()))

    def timed(fn):
        fwd = cuda_ms(fn, ATTN_REPS)
        ms = []
        for _ in range(ATTN_REPS + 1):
            out = fn()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            torch.autograd.grad(out, (q, k, v), g)
            e1.record()
            del out
            ms.append((e0, e1))
        torch.cuda.synchronize()
        return fwd, statistics.median(a.elapsed_time(b) for a, b in ms[1:])

    spans.reset()
    times = {name: timed(fn) for name, fn in routes.items()}
    fwd_flops, bwd_flops = attention_flops(B, S, H, D, True)
    bound = (fwd_flops / BF16_FLOPS_PER_S * 1e3,
             bwd_flops / BF16_FLOPS_PER_S * 1e3)
    rec = {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": None,
        "shape": dict(ATTN_SHAPE, causal=True),
        "ulps_from_plain": gaps,
        "rms_error_kernel_plain": rms,
        "matches_plain": True,
        "build_s": build_s,
        "forward_ms": times["kernel"][0], "backward_ms": times["kernel"][1],
        "bound_forward_ms": bound[0], "bound_backward_ms": bound[1],
        "bound_by": "operations",
        "plain_forward_ms": times["plain"][0],
        "plain_backward_ms": times["plain"][1],
        "library_forward_ms": times["library"][0],
        "library_backward_ms": times["library"][1],
        "tflops_forward": fwd_flops / times["kernel"][0] / 1e9,
        "tflops_backward": bwd_flops / times["kernel"][1] / 1e9,
    }
    log(f"  a call: forward {rec['forward_ms']:.3f} ms "
        f"({rec['tflops_forward']:.0f} TFLOP/s; bound {bound[0]:.3f}, plain "
        f"{times['plain'][0]:.3f}, library {times['library'][0]:.3f}), "
        f"backward {rec['backward_ms']:.3f} ms ({rec['tflops_backward']:.0f} "
        f"TFLOP/s; bound {bound[1]:.3f}, plain {times['plain'][1]:.3f}, "
        f"library {times['library'][1]:.3f})")
    del q, k, v, g
    torch.cuda.empty_cache()
    return rec


def attention_main_path(rec: dict, gates: dict) -> None:
    """Fill in the attention kernel's record (``attention_phase``) from
    phase 7b's profiled steps of olmo-1b at the same shape: the calls by
    route and the kernel's launches counted in the eager tensor-core step
    (a replay runs no Python, so counts nothing), and the kernel's device
    ms in the replay (``ms``) and in the eager step; beside them, the
    bound and the per-call times of ``attention_phase`` times the counted
    launches (``*_from_calls``)."""
    counted = gates["tensor_cores"]["attention_calls"]
    launches = {d: counted[f"attn.launches.{d}"]
                for d in ("forward", "backward")}
    if counted["attn.chunked"] or not counted["attn.fused"] or \
            counted["attn.fused"] != launches["forward"]:
        raise AssertionError(f"the eager olmo-1b step's attention calls "
                             f"{counted}: not all on the kernel")

    def kernel_ms(run):
        return gates[run]["profile"]["categories"].get(
            "attention (fused kernel)", {}).get("ms", 0.0)

    def from_calls(pair):
        return launches["forward"] * pair[0] + launches["backward"] * pair[1]

    rec.update(
        launches=launches,
        step_calls={c: counted[c] for c in ("attn.fused", "attn.chunked")},
        ms=kernel_ms("graph"), eager_step_ms=kernel_ms("tensor_cores"),
        bound_ms=from_calls((rec["bound_forward_ms"],
                             rec["bound_backward_ms"])),
        ms_from_calls=from_calls((rec["forward_ms"], rec["backward_ms"])),
        plain_ms_from_calls=from_calls((rec["plain_forward_ms"],
                                        rec["plain_backward_ms"])),
        library_ms_from_calls=from_calls((rec["library_forward_ms"],
                                          rec["library_backward_ms"])))
    log(f"  attention on the main path: {counted['attn.fused']} fused and "
        f"{counted['attn.chunked']} chunked calls, {launches['forward']} + "
        f"{launches['backward']} launches in an eager step; the kernel "
        f"{rec['ms']:.1f} ms of a replay ({rec['eager_step_ms']:.1f} of the "
        f"eager step; from the calls' times {rec['ms_from_calls']:.1f}), "
        f"bound {rec['bound_ms']:.1f}, plain {rec['plain_ms_from_calls']:.1f}"
        f" and library {rec['library_ms_from_calls']:.1f} from the calls")


def planning_phase(seed: int) -> list:
    """Phase 4: bulk planning through the tier on the card (see the module
    docstring).  Returns one record per run and scheme."""
    import repro_torch.core as core
    from repro_torch.core import torch_engine

    def timed(fn):
        s0 = torch_engine.syncs
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, torch_engine.syncs - s0

    rows = []
    for i, (run, n, k, d, point, B, schemes, source) in enumerate(PLAN_RUNS):
        rng = np.random.default_rng([seed, i])
        if d is None:
            ds = rng.integers(5, 20, size=B)
            nets = [core.OverlayNetwork(draw_caps(rng, 1, int(dd))[0].tolist())
                    for dd in ds]
            params = plan_params(core, n, k, int(ds.max()), point)
            batch = nets
            params_of = (lambda b, nets=nets, params=params:
                         dataclasses.replace(params, d=nets[b].d))
        else:
            caps = draw_caps(rng, B, d)
            batch = torch.from_numpy(caps).to(DEVICE)       # one copy
            nets = [core.OverlayNetwork(c.tolist()) for c in caps]
            params = plan_params(core, n, k, d, point)
            params_of = lambda b, params=params: params
        for scheme in schemes:
            plan = (lambda: core.plan_many(batch, params, scheme))
            res, cold_ms, _ = timed(plan)
            res, warm_ms, syncs = timed(plan)
            if not (res.engine == "batched"
                    and res.times.device.type == torch.device(DEVICE).type
                    and all(t.dtype == torch.float64 for t in
                            (res.times, res.traffic, res.betas))
                    and res.parents.dtype == torch.int64
                    and (res.lower_bounds is None
                         or res.lower_bounds.dtype == torch.float64)):
                raise AssertionError(f"{run}/{scheme}: malformed batch")
            # the same plans with one bisection midpoint per oracle call
            levels = torch_engine._SPEC_LEVELS
            torch_engine._SPEC_LEVELS = 1
            try:
                plain, plain_ms, plain_syncs = timed(plan)
            finally:
                torch_engine._SPEC_LEVELS = levels
            # the same midpoint path, so the same plans: bitwise unless the
            # oracle's sums depend on how many rows a call carries
            plain_bitwise = all(torch.equal(getattr(plain, f), getattr(res, f))
                                for f in ("parents", "times", "betas"))
            if not (torch.equal(plain.parents, res.parents) and all(
                    rel_ok(g, w) for f in ("times", "betas")
                    for g, w in zip(getattr(plain, f).flatten().tolist(),
                                    getattr(res, f).flatten().tolist()))):
                raise AssertionError(f"{run}/{scheme}: plain bisection "
                                     f"planned otherwise")
            lanes = (range(B) if scheme == "star" else
                     sorted(rng.choice(B, size=min(PLAN_CHECK, B),
                                       replace=False).tolist()))
            check = check_lanes(core, scheme, res, nets, params_of, lanes)
            row = dict(run=run, scheme=scheme, source=source, B=B,
                       d=d if d is not None else "5..19",
                       alpha=params.alpha, cold_ms=cold_ms, warm_ms=warm_ms,
                       plans_per_s=B / warm_ms * 1e3, syncs=syncs,
                       spec_levels=levels, plain_bisection_ms=plain_ms,
                       plain_bisection_syncs=plain_syncs,
                       plain_bitwise=plain_bitwise, **check)
            rows.append(row)
            log(f"  {run}/{scheme}: B={B} cold {cold_ms:.1f} ms, warm "
                f"{warm_ms:.1f} ms ({row['plans_per_s']:.0f} plans/s, "
                f"{syncs} device reads), plain bisection {plain_ms:.1f} ms; "
                f"{check['lanes_checked']} lanes within the contract, "
                f"{check['tie_lanes']} ties, max rel err "
                f"{check['max_rel_err']:.2e}, scalar "
                f"{check['scalar_ms_per_plan']:.3f} ms/plan")

    # repair latency: one overlay a call, warm, beside the scalar planner
    rng = np.random.default_rng([seed, len(PLAN_RUNS)])
    caps = draw_caps(rng, B1_OVERLAYS, 10)
    params = plan_params(core, 20, 5, 10, "msr")
    nets = [core.OverlayNetwork(c.tolist()) for c in caps]
    ones = [torch.from_numpy(c[None]).to(DEVICE) for c in caps]
    for scheme in ("star", "fr", "tr", "ftr", "shah"):
        timed(lambda: core.plan_many(ones[0], params, scheme))    # warm-up
        card, reads, scalar, ties, err = [], [], [], 0, 0.0
        for b in range(B1_OVERLAYS):
            res, ms, syncs = timed(
                lambda: core.plan_many(ones[b], params, scheme))
            if not (res.engine == "batched" and res.times.is_cuda):
                raise AssertionError(f"fig7-b1/{scheme}: not planned by the "
                                     f"batched engine on the card")
            check = check_lanes(core, scheme, res, nets[b:b + 1],
                                lambda _: params, [0])
            card.append(ms)
            reads.append(syncs)
            scalar.append(check["scalar_ms_per_plan"])
            ties += check["tie_lanes"]
            err = max(err, check["max_rel_err"])
        row = dict(run="fig7-b1", scheme=scheme,
                   source="benchmarks/fig7_bandwidth.py:14", B=1, d=10,
                   alpha=params.alpha, overlays=B1_OVERLAYS,
                   warm_ms=statistics.median(card), warm_ms_max=max(card),
                   syncs=statistics.median(reads),
                   scalar_ms_per_plan=statistics.median(scalar),
                   lanes_checked=B1_OVERLAYS, tie_lanes=ties,
                   max_rel_err=err)
        rows.append(row)
        log(f"  fig7-b1/{scheme}: {B1_OVERLAYS} overlays one at a time, "
            f"median {row['warm_ms']:.3f} ms on the card (max "
            f"{row['warm_ms_max']:.3f}, {row['syncs']} device reads), scalar "
            f"{row['scalar_ms_per_plan']:.3f} ms on the host; {ties} ties, "
            f"max rel err {err:.2e}")
    return rows


# -- phase 5: the fleet ---------------------------------------------------

def fleet_config_seed(root_seed: int, name: str) -> int:
    """fleet_scale's per-configuration seed (benchmarks/fleet_scale.py:96)."""
    return (root_seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 31)


def fleet_quick_rows(fleet) -> dict:
    """The golden's rows of fleet_scale's quick sweep
    (benchmarks/fleet_scale.py:164-220): steady churn at n = 16 under star,
    ftr and flexible, and the abort-heavy flaky_providers row, each sized
    as 40 failures in expectation."""
    rows = {}
    n, lam = 16, 2e-3
    for pol in ("star", "ftr", "flexible"):
        rows[f"n{n}_lam{lam:g}_{pol}"] = (fleet.SCENARIOS["steady"](
            n, failure_rate=lam, duration=40 / (lam * n)), pol)
    lam = 4e-3
    rows[f"flaky_providers_n{n}_flexible"] = (
        fleet.SCENARIOS["flaky_providers"](n, failure_rate=lam,
                                           duration=40 / (lam * n)),
        "flexible")
    return rows


def summary_close(got: dict, want: dict, label: str) -> float:
    """Hold a fleet summary to a reference one: every key, counts equal,
    floats within 1e-9 relative (a plan-error key is a realized/predicted
    ratio less one, so within 16 ulp of the ratio; ROADMAP C6).  Returns
    the largest relative difference seen (plan-error keys on the ratio)."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if w is None or isinstance(w, int) or g is None:
            if g != w or type(g) is not type(w):
                raise AssertionError(f"{label}.{key}: {g!r} != {w!r}")
            continue
        if math.isinf(w) or math.isinf(g):
            if g != w:
                raise AssertionError(f"{label}.{key}: {g!r} != {w!r}")
            continue
        plan_err = key.startswith("plan_err")
        scale = abs(1.0 + w) if plan_err else abs(w)
        err = abs(g - w) / scale if scale else abs(g - w)
        worst = max(worst, err)
        if abs(g - w) > (PLAN_ERR_TOL if plan_err else REL_TOL) * scale:
            raise AssertionError(f"{label}.{key}: {g!r} vs {w!r}")
    return worst


class TimedPolicy:
    """A repair policy passed through unchanged, with every call timed on
    the host clock to the end of the device's work, and its batch size (R
    overlays, one planning epoch) counted."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.seconds = 0.0
        self.batches = collections.Counter()

    def _timed(self, fn, caps, params, device):
        t0 = time.perf_counter()
        out = fn(caps, params, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.batches[int(caps.shape[0])] += 1
        return out

    def plan_batch(self, caps, params, device=None):
        return self._timed(self.inner.plan_batch, caps, params, device)

    def replan(self, caps, params, device=None):
        return self._timed(self.inner.replan, caps, params, device)

    def replan_candidates(self, caps, params, device=None):
        return self._timed(self.inner.replan_candidates, caps, params, device)


class RecordedPolicy:
    """A policy that records every call's overlays and plans (``record``),
    or answers from such a record (``replay``), raising unless the overlays
    it is given equal the recorded ones bit for bit."""

    def __init__(self, inner, calls=None):
        self.inner = inner
        self.name = inner.name
        self.replay = calls is not None
        self.calls = list(calls) if calls is not None else []
        self.at = 0

    def _call(self, kind, caps, params, device):
        if not self.replay:
            out = getattr(self.inner, kind)(caps, params, device=device)
            self.calls.append((kind, caps.copy(), params.d, out))
            return out
        want_kind, want_caps, want_d, out = self.calls[self.at]
        self.at += 1
        if (kind, params.d) != (want_kind, want_d) or \
                not np.array_equal(caps, want_caps):
            raise AssertionError(f"replayed planning call {self.at - 1} "
                                 f"got other overlays")
        return out

    def plan_batch(self, caps, params, device=None):
        return self._call("plan_batch", caps, params, device)

    def replan(self, caps, params, device=None):
        return self._call("replan", caps, params, device)

    def replan_candidates(self, caps, params, device=None):
        return self._call("replan_candidates", caps, params, device)


def kernel_launches() -> int:
    """The GF(2^8) kernel's launches so far (the program's counter
    ``gf.launches``)."""
    from repro_torch.obs import spans
    return spans.total("gf.launches")


def fresh_peak() -> int:
    """Free what earlier runs left for the collector, reset the peak, and
    return the bytes still allocated: the baseline a run's peak is read
    against."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def fleet_run(label: str, make_sim, policy: TimedPolicy, source: str,
              reduced: str) -> tuple:
    """Build and run one simulator; return (sim, summary, record).  The
    record's ``peak_mem_gib`` is the run's peak device allocation above
    what was allocated when it started (``base_mem_gib``)."""
    base = fresh_peak()
    t0 = time.perf_counter()
    sim = make_sim()
    summary = sim.run().summary()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(run=label, source=source, reduced=reduced, wall_s=wall,
               events=sim.loop_events, events_per_s=sim.loop_events / wall,
               policy_s=policy.seconds, policy_share=policy.seconds / wall,
               planning_calls=sum(policy.batches.values()),
               batch_sizes={str(b): c for b, c in
                            sorted(policy.batches.items())},
               peak_mem_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               base_mem_gib=base / 2**30,
               completed=summary["completed"], aborted=summary["aborted"])
    return sim, summary, rec


def fleet_phase(seed: int, root: pathlib.Path) -> tuple:
    """Phase 5 (see the module docstring).  Returns (records, the kernel's
    fleet-path entry for the ``kernels`` record)."""
    from unittest import mock

    import repro_torch.fleet as fleet
    from repro_torch.core import CodeParams
    from repro_torch.fleet import dataplane as dpmod
    from repro_torch.kernels import gf_matmul, gf_matmul_cuda, gf_matmul_ref
    from repro_torch.obs import json_sanitize
    from repro_torch.storage import uniform_matrix

    params = CodeParams.msr(**FLEET_PARAMS)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    records = []

    # -- a. the golden's quick rows, planned on the card --------------------
    golden = json.loads((root / FLEET_GOLDEN).read_text())
    rows = fleet_quick_rows(fleet)
    for name in sorted(golden["configs"]):
        sc, pol = rows[name]
        policy = TimedPolicy(fleet.make_policy(pol))
        _, summary, rec = fleet_run(
            name, lambda: fleet.FleetSimulator(
                sc, policy, params,
                seed=fleet_config_seed(golden["root_seed"], name),
                device=dev), policy,
            "benchmarks/fleet_scale.py:164-220 (quick sweep)", "none")
        rec["max_rel_err"] = summary_close(json_sanitize(summary),
                                           golden["configs"][name], name)
        records.append(rec)
        log(f"  golden {name}: equal within the contract (max rel err "
            f"{rec['max_rel_err']:.2e}); {rec['wall_s']:.2f} s, "
            f"{rec['events']} events, policy {rec['policy_s']:.2f} s "
            f"({rec['policy_share']:.0%}), B {rec['batch_sizes']}")

    # -- b. region scale with the coded data plane --------------------------
    card = torch.device(DEVICE)
    if dpmod.DataPlane._resolve_matmul("auto", card) is not gf_matmul or \
            dpmod.DataPlane._resolve_matmul("kernel", card) is not gf_matmul:
        raise AssertionError("the data plane's store does not resolve to "
                             "kernels.ops.gf_matmul")
    try:
        dpmod.DataPlane._resolve_matmul("numpy", card)
    except ValueError:
        pass
    else:
        raise AssertionError("a store on the card took the host tables")
    name = f"dataplane_hot_reads_storm_n{REGION_N}_flexible"
    duration = FLEET_EVENTS / (REGION_LAM * REGION_N)
    storm = dataclasses.replace(
        fleet.hot_reads(REGION_N, failure_rate=REGION_LAM, duration=duration,
                        dataplane=True, dataplane_verify=True),
        shock_period=duration / 8, shock_lo=0.35,
        dataplane_payload_bytes=REGION_PAYLOAD)
    region_seed = fleet_config_seed(seed, name)
    source = ("benchmarks/fleet_scale.py:223-243 (the storm row) at "
              "fleet_scale's full event budget (:93) and n = 96")
    reduced = "none: n = 96 of a region's clusters; payload 4 MiB a block"

    def store_matmul(fn):
        return mock.patch.object(dpmod.DataPlane, "_resolve_matmul",
                                 staticmethod(lambda mode, device: fn))

    shape_log = ShapeLog(gf_matmul)
    recorded = RecordedPolicy(fleet.make_policy("flexible"))
    policy = TimedPolicy(recorded)
    launch0 = kernel_launches()
    with store_matmul(shape_log):
        sim, summary, rec = fleet_run(
            name, lambda: fleet.FleetSimulator(storm, policy, params,
                                               seed=region_seed, device=dev),
            policy, source, reduced)
    launches = kernel_launches() - launch0
    torch.cuda.synchronize()
    fleet_ms = shape_log.ms_by_shape()
    store = sim.dataplane.store
    store_mib = sum(nd.payload.numel() for nd in store.nodes.values()) / MIB
    if not (summary["decode_failures"] == 0 and summary["reads_completed"] > 0
            and summary["repair_bytes"] > 0 and summary["decode_checks"]
            == summary["completed"] > 0):
        raise AssertionError(f"{name}: {summary}")
    if launches <= 0 or launches != sum(shape_log.shapes.values()):
        raise AssertionError(f"{name}: {launches} kernel launches for "
                             f"{sum(shape_log.shapes.values())} products")
    if not (store.file_blocks.device.type == torch.device(DEVICE).type
            and store_mib == REGION_N * 2 * REGION_PAYLOAD / MIB):
        raise AssertionError(f"{name}: store of {store_mib} MiB on "
                             f"{store.file_blocks.device}")
    rec.update(kernel_launches=launches,
               kernel_ms=sum(fleet_ms.values()), store_mib=store_mib,
               decode_checks=summary["decode_checks"],
               decode_failures=summary["decode_failures"],
               reads_completed=summary["reads_completed"],
               repair_bytes=summary["repair_bytes"],
               read_bytes=summary["read_bytes"])
    log(f"  {name}: {summary['completed']} repairs, {summary['decode_checks']}"
        f" decode checks, 0 failures, {summary['reads_completed']} reads; "
        f"store {store_mib:.0f} MiB on the card; {launches} kernel launches "
        f"taking {rec['kernel_ms']:.3f} ms between their events; "
        f"{rec['wall_s']:.2f} s, policy {rec['policy_s']:.2f} s "
        f"({rec['policy_share']:.0%}), B {rec['batch_sizes']}, peak "
        f"{rec['peak_mem_gib']:.2f} GiB")
    kernel_nodes = {i: (nd.vectors, nd.payload)
                    for i, nd in store.nodes.items()}
    kernel_file = store.file_blocks
    del sim, store

    # the same run with the store's products on the plain version on the
    # card; the policy answers from the kernel run's record, checking
    # that every planning call sees the same overlays
    replay = TimedPolicy(RecordedPolicy(recorded.inner, recorded.calls))
    with store_matmul(gf_matmul_ref):
        plain_sim, plain_summary, _ = fleet_run(
            name + "/plain", lambda: fleet.FleetSimulator(
                storm, replay, params, seed=region_seed, device=dev),
            replay, source, reduced)
    if kernel_launches() - launch0 != launches:
        raise AssertionError("the plain run reached the kernel")
    plain_store = plain_sim.dataplane.store
    if plain_summary != summary or replay.inner.at != len(recorded.calls) \
            or not torch.equal(plain_store.file_blocks, kernel_file) \
            or sorted(plain_store.nodes) != sorted(kernel_nodes) \
            or not all(torch.equal(nd.vectors, kernel_nodes[i][0])
                       and torch.equal(nd.payload, kernel_nodes[i][1])
                       for i, nd in plain_store.nodes.items()):
        raise AssertionError(f"{name}: kernel and plain stores differ")
    del plain_sim, plain_store
    torch.cuda.empty_cache()

    # traced: planned for real again, the recorder on
    traced_policy = TimedPolicy(fleet.make_policy("flexible"))
    traced_sim, traced, traced_rec = fleet_run(
        name + "/traced", lambda: fleet.FleetSimulator(
            dataclasses.replace(storm, trace=True), traced_policy, params,
            seed=region_seed, device=dev), traced_policy, source, reduced)
    if traced != summary:
        raise AssertionError(f"{name}: the traced summary differs")
    rec.update(plain_store_equal=True, traced_equal=True,
               trace_events=len(traced_sim.recorder),
               traced_wall_s=traced_rec["wall_s"],
               traced_policy_s=traced_rec["policy_s"])
    log(f"  {name}: plain-store run bitwise equal (stores and summary), "
        f"traced run equal ({rec['trace_events']} events recorded, "
        f"{traced_rec['wall_s']:.2f} s)")
    del traced_sim, kernel_nodes, kernel_file
    torch.cuda.empty_cache()

    # the kernel at the fleet's product shapes, against the plain version
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 5)
    shapes = []
    for (m, kk, n), calls in sorted(shape_log.shapes.items()):
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        got, want = gf_matmul_cuda(a, b), gf_matmul_ref(a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at fleet shape "
                                 f"{(m, kk, n)}")
        big = n >= MIB
        t_bytes, t_ops = bound_terms(m, kk, n)
        shapes.append(dict(
            shape=[m, kk, n], calls=calls, fleet_ms=fleet_ms[(m, kk, n)],
            ms=cuda_ms(lambda: gf_matmul_cuda(a, b), 10 if big else 50),
            plain_ms=cuda_ms(lambda: gf_matmul_ref(a, b), 2 if big else 10),
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
            bound_by="operations" if t_ops >= t_bytes else "bytes"))
    del a, b, got, want
    total = {key: sum(r["calls"] * r[key] for r in shapes)
             for key in ("ms", "plain_ms", "bound_ms")}
    for r in sorted(shapes, key=lambda r: -r["fleet_ms"])[:8]:
        log(f"    fleet {r['shape'][0]}x{r['shape'][1]}x{r['shape'][2]}: "
            f"{r['calls']} calls, {r['fleet_ms']:.3f} ms in the run, warm "
            f"{r['ms']:.4f} ms a call (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f}, {r['bound_by']})")
    fleet_kernel = dict(
        run=name, launches=launches, ms=sum(fleet_ms.values()),
        ms_from_shapes=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if sum(r["calls"] * r["ops_ms"] for r in shapes)
                  >= sum(r["calls"] * r["bytes_ms"] for r in shapes)
                  else "bytes"),
        library_ms=None, max_abs_err=0, shapes=shapes)

    # the planning epochs of the storm run: the card against the scalar
    # planners on the host, on the first FLEET_EPOCHS recorded overlays
    card_ms, host_ms = [], []
    host_policy = fleet.make_policy("flexible", engine="scalar")
    for kind, caps, d, _ in recorded.calls[:FLEET_EPOCHS]:
        pe = params if d == params.d else dataclasses.replace(params, d=d)
        t0 = time.perf_counter()
        on_card = recorded.inner.plan_batch(caps, pe, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_host = host_policy.plan_batch(caps, pe, device=dev)
        t2 = time.perf_counter()
        card_ms.append((t1 - t0) * 1e3)
        host_ms.append((t2 - t1) * 1e3)
        for pc, ph in zip(on_card, on_host):
            if not rel_ok(pc.time, ph.time):
                raise AssertionError(f"{name}: epoch plan {pc.time} on the "
                                     f"card, {ph.time} on the host")
    rec.update(epochs_timed=len(card_ms),
               epoch_card_ms=statistics.median(card_ms),
               epoch_host_ms=statistics.median(host_ms))
    log(f"  {name}: {len(card_ms)} planning epochs again, median "
        f"{rec['epoch_card_ms']:.3f} ms on the card, "
        f"{rec['epoch_host_ms']:.3f} ms by the scalar planners on the host")
    records.append(rec)

    # -- c. the ensemble: K = 4 clusters in lockstep, planned on the card ---
    sc = fleet.Scenario(num_nodes=96, duration=600.0, failure_rate=4e-3,
                        capacity_model=uniform_matrix(0.3, 8.0),
                        max_concurrent=32)
    ens_seed = fleet_config_seed(seed, ENSEMBLE_ROW)
    pooled = {}
    for engine in ("auto", "scalar"):
        policies = []

        def factory(engine=engine, policies=policies):
            policies.append(TimedPolicy(fleet.make_policy("star",
                                                          engine=engine)))
            return policies[-1]

        base = fresh_peak()
        t0 = time.perf_counter()
        ens = fleet.ClusterEnsemble(sc, factory, params, clusters=4,
                                    root_seed=ens_seed, device=dev)
        ens.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pooled[engine] = (json_sanitize(ens.pooled().summary()),
                          json_sanitize(ens.cis(ENSEMBLE_CI_KEYS, n_boot=200,
                                                seed=ens_seed)))
        if engine == "auto":
            policy_s = sum(p.seconds for p in policies)
            batches = collections.Counter()
            for p in policies:
                batches.update(p.batches)
            events = sum(s.loop_events for s in ens.sims)
            ens_rec = dict(
                run=ENSEMBLE_ROW, source="benchmarks/fleet_scale.py:143-149",
                reduced="none", wall_s=wall, events=events,
                events_per_s=events / wall, policy_s=policy_s,
                policy_share=policy_s / wall,
                planning_calls=sum(batches.values()),
                batch_sizes={str(b): c for b, c in sorted(batches.items())},
                peak_mem_gib=(torch.cuda.max_memory_allocated() - base)
                / 2**30, base_mem_gib=base / 2**30,
                completed=pooled[engine][0]["completed"],
                aborted=pooled[engine][0]["aborted"])
    ens_rec["max_rel_err_vs_scalar"] = summary_close(
        pooled["auto"][0], pooled["scalar"][0], ENSEMBLE_ROW)
    for key, (lo, mid, hi) in pooled["auto"][1].items():
        summary_close({"lo": lo, "mid": mid, "hi": hi},
                      dict(zip(("lo", "mid", "hi"),
                               pooled["scalar"][1][key])), f"cis.{key}")
    bench = json.loads((root / FLEET_BENCH).read_text())
    if seed == bench["root_seed"]:
        want = dict(bench["configs"][ENSEMBLE_ROW])
        want_cis = want.pop("cis")
        want.pop("clusters")
        ens_rec["max_rel_err_vs_reference"] = summary_close(
            pooled["auto"][0], want, ENSEMBLE_ROW + " vs " + FLEET_BENCH)
        for key, (lo, mid, hi) in pooled["auto"][1].items():
            summary_close({"lo": lo, "mid": mid, "hi": hi},
                          dict(zip(("lo", "mid", "hi"), want_cis[key])),
                          f"{FLEET_BENCH} cis.{key}")
    records.append(ens_rec)
    log(f"  {ENSEMBLE_ROW}: pooled summary and bootstrap intervals equal the "
        f"scalar engine's within the contract"
        + (f" and {FLEET_BENCH}'s" if seed == bench["root_seed"] else "")
        + f"; {ens_rec['completed']} repairs, {ens_rec['aborted']} aborts, "
        f"{ens_rec['wall_s']:.2f} s, policy {ens_rec['policy_s']:.2f} s "
        f"({ens_rec['policy_share']:.0%}), B {ens_rec['batch_sizes']}")
    return records, fleet_kernel


# -- phase 3: the kernel's mapping probes ----------------------------------

def mapping_probes(compare, gen) -> None:
    """The kernel against the plain version (``compare(a, b, label)``
    raises unless they are equal) on probes that put every byte where the
    layout says, in both variants: the identity with single-bit payloads at
    every N % 8 (N = 1000 takes the aligned variant, 1001..1008 the shifted
    one or, at 1008, the aligned one again), one set bit in a zero payload
    at the tile edges 511/512/513 and at the last column, ragged and
    chunked shapes, B 1..7 bytes off alignment, K = 1024 (chunked) at odd
    N, M = 9..11 (two bands; at odd N the rows of C start at every offset
    mod 8), the identity and zeros at N = 1e6."""
    for kk in (1, 2, 3, 4, 5, 1024):
        eye = torch.eye(kk, dtype=torch.uint8, device=DEVICE)
        for n in range(1000, 1009):
            for bit in range(8):
                b = torch.full((kk, n), 1 << bit, dtype=torch.uint8,
                               device=DEVICE)
                if not torch.equal(compare(eye, b, f"I_{kk}, N={n}, bit {bit}"),
                                   b):
                    raise AssertionError(f"I . B != B at K={kk}, N={n}, "
                                         f"bit {bit}")
    a = rand_u8((9, 37), gen)
    for k0, n0, bit in [(0, 0, 0), (36, 511, 7), (3, 512, 1), (5, 513, 3),
                        (17, 1000, 6), (36, -1, 5), (0, -1, 2)]:
        for n in (1001, 1003, 1007, 1024, 1031):
            b = torch.zeros((37, n), dtype=torch.uint8, device=DEVICE)
            col = n - 1 if n0 < 0 else min(n0, n - 1)
            b[k0, col] = 1 << bit
            got = compare(a, b, f"one bit at ({k0}, {col}, {bit}), N={n}")
            if got[:, col].eq(0).all() or got[:, :col].any() \
                    or got[:, col + 1:].any():
                raise AssertionError(f"one bit at ({k0}, {col}), N={n}: "
                                     f"output outside column {col}")
    for m, kk, n in [(1, 1, 1), (7, 13, 1_000_003), (33, 1024, 100_000),
                     (64, 1024, 4096), (5, 3, 17), (11, 48, 100_003),
                     (9, 1024, 100_001), (33, 1024, 4097), (9, 48, 1001),
                     (10, 48, 1003), (11, 48, 1005), (9, 16, 513),
                     (10, 64, 511)]:
        compare(rand_u8((m, kk), gen), rand_u8((kk, n), gen), (m, kk, n))
    base = rand_u8((1, 8 * 4097 + 8), gen)[0]
    for off in range(1, 8):
        compare(rand_u8((5, 8), gen), base[off:off + 8 * 4096].view(8, 4096),
                f"B at {off} bytes off, N=4096")
        compare(rand_u8((11, 8), gen), base[off:off + 8 * 4097].view(8, 4097),
                f"B at {off} bytes off, N=4097")
    b = rand_u8((64, 1_000_000), gen)
    eye = torch.eye(64, dtype=torch.uint8, device=DEVICE)
    if not torch.equal(compare(eye, b, "identity"), b):
        raise AssertionError("I . B != B")
    zero = compare(torch.zeros((16, 64), dtype=torch.uint8, device=DEVICE),
                   b, "zeros")
    if zero.any():
        raise AssertionError("0 . B != 0")


# -- phase 6: checkpoint regeneration and the LM stack at full width -------

def kernel_at_shapes(shape_log: "ShapeLog", phase_ms, seed: int,
                     label: str) -> tuple:
    """The kernel at every product shape ``shape_log`` saw, on fresh
    operands at the full width, held to the plain version on column windows
    (the first and the last FT_WINDOW bytes, which hold the ragged tail) and
    timed beside its bound.  A row names the variant the shape launched;
    where that is the shifted one, ``aligned_ms`` is the aligned variant's
    warm time at the same M and K with N rounded down to a multiple of 8
    (the same storage, so no copy): the shifted variant's yardstick.
    Returns (rows, totals over the calls)."""
    import importlib

    from repro_torch.kernels import gf_matmul_cuda, gf_matmul_ref
    kmod = importlib.import_module("repro_torch.kernels.gf_matmul")
    sms = kmod.device_sms(torch.device(DEVICE, torch.cuda.current_device()))

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    shapes = []
    for (m, kk, n), calls in sorted(shape_log.shapes.items()):
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        got = gf_matmul_cuda(a, b)
        wins = sorted({(0, min(FT_WINDOW, n)), (max(0, n - FT_WINDOW), n)})
        bws = [b[:, lo:hi].contiguous() for lo, hi in wins]
        for (lo, hi), bw in zip(wins, bws):
            if not torch.equal(got[:, lo:hi], gf_matmul_ref(a, bw)):
                raise AssertionError(f"kernel != plain at {label} shape "
                                     f"{(m, kk, n)}, columns {lo}:{hi}")
        variant = kmod.VARIANTS[kmod.launch_plan(
            m, kk, n, sms, aligned=kmod.operands_aligned(b, got)).variant].name
        del got
        big = n >= MIB
        reps = 2 if big else 20
        t_bytes, t_ops = bound_terms(m, kk, n)
        n8 = n - n % 8
        aligned_ms = None
        if variant == "shifted" and n8:
            b8 = b.view(-1)[:kk * n8].view(kk, n8)
            aligned_ms = cuda_ms(lambda: gf_matmul_cuda(a, b8), reps)
            del b8
        shapes.append(dict(
            shape=[m, kk, n], calls=calls, phase_ms=phase_ms[(m, kk, n)],
            variant=variant, aligned_ms=aligned_ms,
            ms=cuda_ms(lambda: gf_matmul_cuda(a, b), reps),
            windows=[list(w) for w in wins],
            window_ms=sum(cuda_ms(lambda: gf_matmul_cuda(a, bw), 3)
                          for bw in bws),
            plain_window_ms=sum(cuda_ms(lambda: gf_matmul_ref(a, bw), 1)
                                for bw in bws),
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
            bound_by="operations" if t_ops >= t_bytes else "bytes"))
        del a, b, bws
        torch.cuda.empty_cache()
    total = {key: sum(r["calls"] * r[key] for r in shapes)
             for key in ("ms", "window_ms", "plain_window_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
    for r in sorted(shapes, key=lambda r: -r["phase_ms"])[:8]:
        log(f"    {label} {r['shape'][0]}x{r['shape'][1]}x{r['shape'][2]}: "
            f"{r['calls']} calls, {r['phase_ms']:.3f} ms in the phase, warm "
            f"{r['ms']:.3f} ms a call ({r['variant']}; aligned at N - N % 8 "
            f"{r['aligned_ms']} ms; bound {r['bound_ms']:.3f}, "
            f"{r['bound_by']}); windows {r['window_ms']:.3f} ms, plain "
            f"{r['plain_window_ms']:.3f}")
    return shapes, total


def ft_phase(seed: int, cfg, model) -> tuple:
    """Phase 6a (see the module docstring): ``model`` (of ``cfg``) is saved
    as an erasure-coded checkpoint, host FT_FAILED is regenerated with each
    scheme and the state restored.  Returns (record, the kernel's
    checkpoint-path entry for the ``kernels`` record)."""
    from unittest import mock

    from repro_torch.ft import ECCheckpoint, ErasureCoder, Fleet, FleetConfig
    from repro_torch.ft import checkpoint as ckmod
    from repro_torch.ft.erasure import tree_flatten
    from repro_torch.ft.walkthrough import same_bytes
    from repro_torch.kernels import gf_matmul

    dev = torch.device(DEVICE, torch.cuda.current_device())
    state = {"params": model.state_dict(),
             "step": torch.tensor(1000, dtype=torch.int32, device=dev)}
    want, _ = tree_flatten(state)
    shape_log = ShapeLog(gf_matmul)
    coder = ErasureCoder(**FT_CODER, seed=seed, device=dev, matmul=shape_log)
    ckpt = ECCheckpoint(Fleet(FleetConfig(**FT_FLEET), seed=seed), coder,
                        FT_HOSTS, seed=seed)
    base = fresh_peak()
    launch0 = kernel_launches()
    t0 = time.perf_counter()
    ckpt.save(state, step=1000)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    save_launches = kernel_launches() - launch0
    group, spec = ckpt.group, ckpt.spec
    block_bytes = group.block_bytes
    if not (block_bytes == math.ceil(spec.total_bytes / coder.M)
            and sorted(group.shards) == sorted(FT_HOSTS)
            and all(sh.payload.shape == (coder.alpha, block_bytes)
                    and sh.payload.device == dev
                    for sh in group.shards.values())):
        raise AssertionError("the checkpoint's shards are malformed")
    save_peak = torch.cuda.max_memory_allocated() - base
    log(f"  save: {spec.total_bytes} B of state ({len(want)} leaves) as "
        f"M = {coder.M} blocks of {block_bytes} B, {len(FT_HOSTS)} hosts x "
        f"{coder.alpha} coded blocks on the card; {save_s:.3f} s, "
        f"{save_launches} launches, peak {save_peak / 2**30:.2f} GiB above "
        f"the baseline")

    plan_s = []
    core_plan = ckmod.plan_recovery

    def timed_plan(*a, **kw):
        t = time.perf_counter()
        out = core_plan(*a, **kw)
        plan_s.append(time.perf_counter() - t)
        return out

    others = [h for h in FT_HOSTS if h != FT_FAILED]
    repairs = []
    with mock.patch.object(ckmod, "plan_recovery", timed_plan):
        for i, scheme in enumerate(FT_SCHEMES):
            launched = kernel_launches()
            rec_log = ckpt.on_host_failure(FT_FAILED, scheme=scheme)
            launched = kernel_launches() - launched
            shard = group.shards[FT_FAILED]
            if launched <= 0 or shard.payload.shape != (coder.alpha,
                                                        block_bytes):
                raise AssertionError(f"{scheme}: {launched} launches, shard "
                                     f"{tuple(shard.payload.shape)}")
            d = rec_log.decision
            rep = dict(scheme=scheme, chosen=d.plan.scheme,
                       providers=d.providers, predicted_s=d.predicted_s,
                       alternatives=d.alternatives,
                       blocks_moved=rec_log.report.blocks_moved, M=coder.M,
                       plan_s=plan_s[-1],
                       execute_s=rec_log.wall_s - plan_s[-1],
                       launches=launched, restores=[])
            for hosts in ([FT_FAILED] + others[i:i + 3],
                          (others * 2)[i + 3:i + 7]):
                t0 = time.perf_counter()
                restored = ckpt.restore(hosts)
                torch.cuda.synchronize()
                t_restore = time.perf_counter() - t0
                got, _ = tree_flatten(restored)
                if len(got) != len(want) or not all(
                        same_bytes(a, b) for a, b in zip(want, got)):
                    raise AssertionError(f"{scheme}: restore from {hosts} "
                                         f"differs")
                del restored, got
                rep["restores"].append(dict(hosts=hosts, s=t_restore))
            repairs.append(rep)
            log(f"  fail {FT_FAILED}, {scheme}: {d.plan.scheme} predicted "
                f"{d.predicted_s:.4f} s, {rep['blocks_moved']:.0f} blocks "
                f"moved (M = {coder.M}); plan {rep['plan_s']:.4f} s, execute "
                f"{rep['execute_s']:.3f} s ({launched} launches); restore "
                + ", ".join(f"{r['hosts']} {r['s']:.3f} s"
                            for r in rep["restores"]) + ": bit for bit")
    launches = kernel_launches() - launch0
    torch.cuda.synchronize()
    phase_ms = shape_log.ms_by_shape()
    if launches <= save_launches or launches != sum(shape_log.shapes.values()):
        raise AssertionError(f"{launches} kernel launches for "
                             f"{sum(shape_log.shapes.values())} products")
    peak = torch.cuda.max_memory_allocated() - base
    record = dict(arch=cfg.name, source="examples/regenerate_checkpoint.py:"
                  "20-28", reduced="none", params=sum(
                      t.numel() for t in model.state_dict().values()),
                  state_bytes=spec.total_bytes, leaves=len(want),
                  block_bytes=block_bytes, M=coder.M,
                  coded_bytes=len(FT_HOSTS) * coder.alpha * block_bytes,
                  save_s=save_s, save_launches=save_launches,
                  repairs=repairs, launches=launches,
                  kernel_ms=sum(phase_ms.values()),
                  save_peak_gib=save_peak / 2**30, peak_gib=peak / 2**30,
                  base_gib=base / 2**30)
    log(f"  checkpoint path: {launches} kernel launches taking "
        f"{record['kernel_ms']:.3f} ms between their events; peak "
        f"{record['peak_gib']:.2f} GiB above {record['base_gib']:.2f} GiB")
    del ckpt, group, coder, state, want, shard
    fresh_peak()

    shapes, total = kernel_at_shapes(shape_log, phase_ms, seed + 6, "ft")
    ft_kernel = dict(
        run=f"checkpoint {cfg.name}", launches=launches, ms=record["kernel_ms"],
        ms_from_shapes=total["ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"]
        else "bytes", window_ms=total["window_ms"],
        plain_window_ms=total["plain_window_ms"], library_ms=None,
        max_abs_err=0, shapes=shapes)
    return record, ft_kernel


def lm_phase(seed: int, cfg, model) -> dict:
    """Phase 6b (see the module docstring): prefill and teacher-forced
    decode of ``model`` on the card, held to its parallel forward, and one
    layer's chunked attention held to a dense fp32 attention."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.models.layers import chunked_attention

    dev = torch.device(DEVICE, torch.cuda.current_device())
    S, T = LM_PROMPT, LM_DECODE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab_size, (1, S + T), device=dev,
                         generator=gen)
    base = fresh_peak()
    prefill_s = []
    for _ in range(2):                      # cold, then warm
        cache = init_cache(cfg, 1, S + T, dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        first, cache = prefill(cfg, model, {"tokens": toks[:, :S]}, cache)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    eager, graphed, graph_rec = eager_vs_graph(cfg, model, cache,
                                               toks[:, S:], S, S + T)
    decode_s = [t / 1e3 for t in graph_rec.pop("eager_ms_each")]
    t0 = time.perf_counter()
    want = forward_logits(cfg, model, {"tokens": toks}, S)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    gate = forward_gap(cfg, want, first, eager, graphed, tol=LM_LOGIT_TOL)
    logit_scale, logit_err = gate["logit_max_abs"], gate["logit_max_abs_err"]
    argmax_equal = gate["argmax_equal"]
    lm_peak = torch.cuda.max_memory_allocated() - base
    del cache, eager, graphed, want

    # layer 0's chunked attention against a dense fp32 attention
    with torch.no_grad():
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        blk = model.blocks[0]
        q, k, v = blk.attn.qkv(blk.norm1(model.embed.tokens(toks[:, :S])), pos)
        t0 = time.perf_counter()
        att = chunked_attention(q, k, v, causal=True, q_positions=pos,
                                kv_positions=pos, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        torch.cuda.synchronize()
        attn_s = time.perf_counter() - t0
        G = cfg.num_heads // cfg.num_kv_heads
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float().repeat_interleave(G, dim=2)) \
            / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~torch.tril(torch.ones(
            S, S, dtype=torch.bool, device=dev)), -math.inf)
        dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                             v.float().repeat_interleave(G, dim=2))
        diff = (att.float() - dense).abs()
        attn_err = float(diff.max())
        if not bool((diff <= ATTN_TOL + ATTN_TOL * dense.abs()).all()):
            raise AssertionError(f"chunked attention differs from dense by "
                                 f"{attn_err}")
    rec = dict(arch=cfg.name, prompt=S, decode_tokens=T,
               prefill_cold_ms=prefill_s[0] * 1e3,
               prefill_ms=prefill_s[1] * 1e3,
               decode_first_ms=decode_s[0] * 1e3,
               decode_ms_per_token=statistics.median(decode_s[1:]) * 1e3,
               decode_ms=[t * 1e3 for t in decode_s],
               graph=graph_rec,
               forward_ms=forward_s * 1e3, logit_max_abs_err=logit_err,
               logit_max_abs=logit_scale, logit_tol=LM_LOGIT_TOL,
               argmax_equal=argmax_equal, attention_ms=attn_s * 1e3,
               attention_max_abs_err=attn_err, attention_tol=ATTN_TOL,
               peak_gib=lm_peak / 2**30, base_gib=base / 2**30)
    log(f"  {cfg.name} prefill S = {S}: {rec['prefill_cold_ms']:.1f} ms cold, "
        f"{rec['prefill_ms']:.1f} ms warm; eager decode "
        f"{rec['decode_first_ms']:.1f} ms the first token, median "
        f"{rec['decode_ms_per_token']:.2f} ms the others; teacher-forced "
        f"logits within {logit_err['eager']:.4f} (eager) and "
        f"{logit_err['graph']:.4f} (graph) of the forward's (largest "
        f"{logit_scale:.3f}, argmax equal {argmax_equal['eager']:.2f} and "
        f"{argmax_equal['graph']:.2f}); layer-0 attention within "
        f"{attn_err:.5f} of dense fp32; peak {rec['peak_gib']:.2f} GiB above "
        f"{rec['base_gib']:.2f} GiB")
    return rec


@torch.no_grad()
def forward_logits(cfg, model, batch, start: int) -> torch.Tensor:
    """The parallel forward's fp32 logits over ``batch`` at positions
    start-1 .. the end: (B, T+1, V)."""
    from repro_torch.models import embed_inputs, forward_hidden

    h = embed_inputs(cfg, model, batch)
    h, _ = forward_hidden(cfg, model, h, positions=torch.arange(
        h.shape[1], dtype=torch.int32, device=h.device))
    h = model.final_norm(h)
    return h[:, start - 1:].float() @ model.embed.table().float().t()


def forward_gap(cfg, want, first, eager, graphed, tol=None) -> dict:
    """The prefill's logits ``first`` (B, V) and each path's teacher-forced
    step logits ((T, B, V)) against the forward's, ``want``
    (``forward_logits``), at their positions: the forward's largest
    |logit|, each path's largest difference and the share of positions
    whose argmax equals the forward's.  Every logit must be finite; with
    ``tol``, each difference must be within ``tol`` times that largest
    |logit| (the gate of 6b)."""
    scale = float(want.abs().max())
    err, argmax_equal = {}, {}
    for path, steps in (("eager", eager), ("graph", graphed)):
        got = torch.cat([first[:, None], steps.transpose(0, 1)], dim=1)
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{cfg.name}: non-finite logits ({path})")
        err[path] = float((got - want).abs().max())
        if tol is not None and err[path] > tol * scale:
            raise AssertionError(f"{cfg.name}: {path} decode logits differ "
                                 f"from the forward's by {err[path]}, over "
                                 f"{tol} x {scale}")
        argmax_equal[path] = float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean())
    return dict(logit_max_abs=scale, logit_max_abs_err=err,
                argmax_equal=argmax_equal, logit_tol=tol)


@contextlib.contextmanager
def room_for_every_pair(model):
    """Each MoE block with the capacity for every (token, expert) pair of
    a row, so that a prefill and a parallel forward drop none, as a decode
    step (one token a row, K distinct experts, capacity at least 1) never
    does; the decode step's capacity is the same with it or without."""
    from repro_torch.models.moe import MoE

    mods = [m for m in model.modules() if isinstance(m, MoE)]
    saved = [m.cfg for m in mods]
    for m in mods:
        m.cfg = dataclasses.replace(m.cfg, moe_capacity_factor=(
            m.cfg.num_experts / m.cfg.experts_per_token))
    try:
        yield
    finally:
        for m, c in zip(mods, saved):
            m.cfg = c


def bf16_ulp(x: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def device_profile(fn) -> dict:
    """What one call of ``fn`` ran on the card (``torch.profiler``, CPU and
    CUDA activities): kernels, copies and sets, their summed device ms, the
    span from the first start to the last end, and the five kernels taking
    the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kern:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) / 1e3 if evs else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return dict(kernels=len(kern), copies=len(evs) - len(kern),
                device_busy_ms=busy, device_span_ms=span,
                top=[dict(name=n[:160], calls=c, ms=ms)
                     for n, (c, ms) in top])


GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat",
            "aten::stack", "aten::contiguous"}
REGIONS = {"chunked_attention": "attention", "fused_attention": "attention",
           "chunked_softmax_xent": "loss",
           "_adamw_update": "optimizer", "_adafactor_update": "optimizer",
           "global_norm": "optimizer"}
ATTN_KERNELS = ("attn_fwd", "attn_bwd_prep", "attn_bwd_kv", "attn_bwd_q",
                "attn_bounds")
CATEGORIES = ("attention (fused kernel)", "bf16 GEMMs", "fp32 GEMMs",
              "attention (elementwise and "
              "reductions)", "loss", "optimizer", "casts and copies", "other")


@contextlib.contextmanager
def labelled_regions():
    """Each function named in ``REGIONS``, wherever a ``repro_torch`` module
    binds it, run inside a ``torch.profiler.record_function`` range named
    ``region:<its region>``, so ``step_profile`` can tell the attention,
    the loss and the optimizer apart."""
    def labelled(fn, region):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with torch.profiler.record_function("region:" + region):
                return fn(*args, **kwargs)
        return run

    patched = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch"):
            continue
        for attr, region in REGIONS.items():
            fn = mod.__dict__.get(attr)
            if callable(fn):
                patched.append((mod, attr, fn))
                setattr(mod, attr, labelled(fn, region))
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def _region(op):
    """The region of ``op``'s innermost ``region:`` range, or None."""
    while op is not None:
        if op.name.startswith("region:"):
            region = op.name[len("region:"):]
            return ("attention (elementwise and reductions)"
                    if region == "attention" else region)
        op = op.cpu_parent
    return None


def _category(op, fwd_ops: dict, dtypes: dict) -> str:
    """The category of a kernel launched by the CPU op ``op``: a GEMM by
    its first input's dtype, a cast or copy, else the region of the op's
    innermost ``region:`` range; in the backward, outside such a range,
    the region of the forward op that made the autograd node being
    evaluated (same sequence number and thread), so a remat's recomputed
    forward outside the ranges counts where that node does."""
    if op.name in GEMM_OPS:
        dtype = (dtypes.get(op.id) or [""])[0]
        return ("bf16 GEMMs" if "BFloat16" in dtype else "fp32 GEMMs"
                if dtype == "float" else f"GEMMs ({dtype})")
    if op.name in COPY_OPS:
        return "casts and copies"
    e = op
    while e is not None:
        if e.name.startswith("region:"):
            return _region(e)
        if e.name.startswith("autograd::engine::evaluate_function"):
            fwd = fwd_ops.get((e.sequence_nr, e.fwd_thread))
            return (fwd is not None and _region(fwd)) or "other"
        e = e.cpu_parent
    return "other"


def _attn_kernel(name: str) -> bool:
    """Whether a device event is one of the fused attention's kernels."""
    return any(name.startswith(k) or f"::{k}(" in name for k in ATTN_KERNELS)


def step_profile(fn, like=None) -> dict:
    """What one call of ``fn`` ran on the card (``torch.profiler``, CPU and
    CUDA activities, input dtypes recorded, ``labelled_regions`` on): the
    kernels (and copies and sets) and their device ms by category
    (``CATEGORIES``; each device event by the CPU op that launched it), the
    device's busy ms (the union of its events), the span from the first
    start to the last end, the call's host ms to a synchronize, and the
    idle shares of the span and of the call.  A graph's replay launches
    no op: with ``like`` (the record of an eager call of the same step),
    each of the replay's device events takes the category of ``like``'s
    next event of the same name, in order (looked for among the next 64;
    an event with none is ``unattributed``).  ``order`` (the events' names
    and categories) is for ``like`` and is left out of a JSON record."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with labelled_regions(), torch.profiler.profile(
            activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kineto = prof.profiler.kineto_results.events()
    ops = {e.id: e for e in prof.events() if e.device_type != cuda}
    dtypes = {k.correlation_id(): k.dtypes() for k in kineto
              if k.device_type() != cuda}
    fwd_ops = {(e.sequence_nr, e.thread): e for e in ops.values()
               if e.sequence_nr >= 0 and "Backward" not in e.name
               and not e.name.startswith("autograd::")}
    # kineto's own events: a device event's linked correlation id is the
    # id of the CPU op that launched it, and a CPU op's input dtypes are
    # there (torch 2.11's FunctionEvents carry neither)
    # (the ``region:`` ranges also appear on the device's timeline, as
    # spans around their kernels: left out)
    dev = sorted((k for k in kineto if k.device_type() == cuda
                  and not k.name().startswith("region:")),
                 key=lambda k: k.start_ns())
    names = [k.name() for k in dev]
    if like is not None:
        cats, j = [], 0
        for name in names:
            k = next((k for k in range(j, min(j + 64, len(like["order"])))
                      if like["order"][k][0] == name), None)
            cats.append("unattributed" if k is None else like["order"][k][1])
            j = j if k is None else k + 1
    else:
        cats = []
        for k, name in zip(dev, names):
            op = ops.get(k.linked_correlation_id())
            cats.append("attention (fused kernel)" if _attn_kernel(name)
                        else "casts and copies" if name.startswith(
                            ("Memcpy", "Memset")) else "unattributed"
                        if op is None else _category(op, fwd_ops, dtypes))
    by_cat = collections.defaultdict(lambda: dict(events=0, ms=0.0))
    top = collections.defaultdict(lambda: collections.defaultdict(float))
    busy, end = 0, None
    for k, name, cat in zip(dev, names, cats):
        start, stop = k.start_ns(), k.start_ns() + k.duration_ns()
        by_cat[cat]["events"] += 1
        by_cat[cat]["ms"] += (stop - start) / 1e6
        top[cat][name[:120]] += (stop - start) / 1e6
        if end is None or start >= end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    busy_ms = busy / 1e6
    span_ms = (end - dev[0].start_ns()) / 1e6 if dev else 0.0
    for cat, rec in by_cat.items():
        rec["top"] = [dict(name=n, ms=ms) for n, ms in sorted(
            top[cat].items(), key=lambda kv: -kv[1])[:3]]
    kernels = sum(1 for n in names if not n.startswith(("Memcpy", "Memset")))
    return dict(kernels=kernels, events=len(dev), categories=dict(by_cat),
                device_busy_ms=busy_ms, device_span_ms=span_ms,
                wall_ms=wall_ms,
                idle_share_of_span=1 - busy_ms / span_ms if span_ms else None,
                idle_share_of_wall=1 - busy_ms / wall_ms,
                order=list(zip(names, cats)))


def profile_line(label: str, prof: dict) -> str:
    cats = sorted(prof["categories"].items(), key=lambda kv: -kv[1]["ms"])
    return (f"  {label}: {prof['kernels']} kernels, busy "
            f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
            f"(idle {prof['idle_share_of_wall']:.3f} of the profiled call, "
            f"{prof['idle_share_of_span']:.3f} of the span"
            + (f", {prof['idle_share_of_step']:.3f} of the unprofiled step"
               if "idle_share_of_step" in prof else "") + "); "
            + "; ".join(f"{c} {r['ms']:.1f} ms ({r['events']})"
                        for c, r in cats))


def decode_bound(cfg, model, cache, tokens, pos: int) -> dict:
    """The least time of one decode step over ``cache``: the bytes it must
    move over HBM.  Every parameter read once, but of the token table only
    the B rows looked up and of the MoE experts only those this step routes
    to (counted with a hook on each MoE's input, during one eager step of
    ``tokens`` at ``pos``, which rewrites that slot as the step did);
    every cache buffer read once, the SSM's conv and state written once,
    one KV slot a layer written, the fp32 logits written."""
    from repro_torch.models import decode_step
    from repro_torch.models.moe import MoE

    B = tokens.shape[0]
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tok = getattr(model.embed, "tok", None)
    if tok is not None:
        nbytes -= (tok.shape[0] - B) * tok.shape[1] * tok.element_size()
    hooks, unused = [], []

    def routed(mod, args):
        logits = args[0].float() @ mod.router
        ids = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
        hit = torch.unique(ids[..., :cfg.experts_per_token]).numel()
        per = sum(w[0].numel() * w.element_size()
                  for w in (mod.we_gate, mod.we_up, mod.we_down))
        unused.append((cfg.num_experts - hit) * per)

    for mod in model.modules():
        if isinstance(mod, MoE):
            hooks.append(mod.register_forward_pre_hook(routed))
    try:
        decode_step(cfg, model, cache, tokens, pos)
    finally:
        for h in hooks:
            h.remove()
    nbytes -= sum(unused)
    for key, buf in cache.items():
        size = buf.numel() * buf.element_size()
        nbytes += 2 * size if key in ("conv", "state") else \
            size + size // buf.shape[2]
    nbytes += B * cfg.vocab_size * 4
    return dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", experts_unused_bytes=sum(unused))


def eager_vs_graph(cfg, model, cache, toks, start: int, max_len: int
                   ) -> tuple:
    """Teacher-forced decode of ``toks`` ((B, T), at positions start ..
    start+T-1) from the prefilled ``cache``, through eager ``decode_step``
    (an int position) on ``cache`` and through a ``DecodeGraph`` whose
    cache is a copy of it, in turns (which goes first alternates a step).
    Every step's graph logits must equal the eager ones, bitwise or within
    one bf16 ulp of the step's largest |logit|.  Returns (eager logits (T,
    B, V), graph logits, record: host ms to a synchronize and CUDA-event ms
    of each path a step, the graph's build and capture ms, the kernels of
    one eager step and of one replay, the step's bytes bound)."""
    from repro_torch.models import decode_step
    from repro_torch.serve import DecodeGraph

    B, T = toks.shape
    dev = toks.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = DecodeGraph(cfg, model, B, max_len, dtype=torch.float32
                        if cfg.param_dtype == "float32" else torch.bfloat16,
                        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for key, buf in cache.items():
        graph.cache[key].copy_(buf)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    host = {"eager": [], "graph": []}
    event = {"eager": [], "graph": []}
    out = {"eager": [], "graph": []}
    for i in range(T):
        tok = toks[:, i:i + 1]
        for path in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            t0 = time.perf_counter()
            ev0.record()
            if path == "eager":
                logits, _ = decode_step(cfg, model, cache, tok, start + i)
            else:
                logits = graph(tok, start + i)
            ev1.record()
            torch.cuda.synchronize()
            host[path].append((time.perf_counter() - t0) * 1e3)
            event[path].append(ev0.elapsed_time(ev1))
            out[path].append(logits.clone())
    eager, graphed = torch.stack(out["eager"]), torch.stack(out["graph"])
    bitwise = bool(torch.equal(eager, graphed))
    diffs, tols = [], []
    for e, g in zip(eager, graphed):
        diffs.append(float((g - e).abs().max()))
        tols.append(bf16_ulp(float(e.abs().max())))
        if not (torch.isfinite(e).all() and torch.isfinite(g).all()):
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        if diffs[-1] > tols[-1]:
            raise AssertionError(f"{cfg.name}: the graph's logits differ "
                                 f"from eager decode_step's by {diffs[-1]}, "
                                 f"over one bf16 ulp ({tols[-1]})")
    last = toks[:, -1:]
    bound = decode_bound(cfg, model, cache, last, start + T - 1)
    eager_prof = device_profile(
        lambda: decode_step(cfg, model, cache, last, start + T - 1))
    graph_prof = device_profile(lambda: graph(last, start + T - 1))
    rec = dict(arch=cfg.name, batch=B, start=start, steps=T, max_len=max_len,
               build_ms=build_s * 1e3, capture_ms=graph.capture_s * 1e3,
               eager_ms=spread([t / 1e3 for t in host["eager"]]),
               graph_ms=spread([t / 1e3 for t in host["graph"]]),
               eager_event_ms=spread([t / 1e3 for t in event["eager"]]),
               graph_event_ms=spread([t / 1e3 for t in event["graph"]]),
               eager_ms_each=host["eager"], graph_ms_each=host["graph"],
               bitwise=bitwise, max_abs_diff=max(diffs),
               ulp_tol=min(tols),
               eager_profile=eager_prof, graph_profile=graph_prof, **bound)
    log(f"  {cfg.name} decode B = {B} at {start}..{start + T - 1}: eager "
        f"median {rec['eager_ms']['median']:.2f} ms a step (events "
        f"{rec['eager_event_ms']['median']:.2f}), graph "
        f"{rec['graph_ms']['median']:.2f} ms (events "
        f"{rec['graph_event_ms']['median']:.2f}); bound "
        f"{bound['bound_ms']:.3f} ms; build {rec['build_ms']:.1f} ms, "
        f"capture {rec['capture_ms']:.1f} ms; logits "
        f"{'bitwise equal' if bitwise else 'within %g' % max(diffs)} "
        f"(1 bf16 ulp >= {min(tols):g}); kernels a step: eager "
        f"{eager_prof['kernels']}, replay {graph_prof['kernels']} (device "
        f"busy {graph_prof['device_busy_ms']:.2f} of "
        f"{graph_prof['device_span_ms']:.2f} ms)")
    del graph
    return eager, graphed, rec


def graph_phase(seed: int) -> dict:
    """Phase 6b' (see the module docstring): eager decode against the
    captured graph at olmoe-1b-7b and zamba2-7b's full width in bf16, then
    both paths held to the parallel forward with fp32 weights, one model
    on the card at a time; then the graph against eager at every causal
    smoke config."""
    from repro_torch.configs import get_config

    dev = torch.device(DEVICE, torch.cuda.current_device())
    recs = []
    for arch in GRAPH_ARCHS:
        cfg = get_config(arch)
        rec = graph_cell(cfg, seed, dev)
        log(f"    bf16: teacher-forced logits within "
            f"{rec['forward']['logit_max_abs_err']['eager']:.4f} of the "
            f"forward's (largest {rec['forward']['logit_max_abs']:.3f}; "
            f"recorded, not gated)")
        rec["fp32"] = graph_cell(dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32"), seed, dev,
            tol=FP32_LOGIT_TOL)
        gate = rec["fp32"]["forward"]
        log(f"    fp32: teacher-forced logits within "
            f"{gate['logit_max_abs_err']['eager']:.2e} (eager) and "
            f"{gate['logit_max_abs_err']['graph']:.2e} (graph) of the "
            f"forward's (largest {gate['logit_max_abs']:.3f}, gate "
            f"{FP32_LOGIT_TOL} of it; argmax equal "
            f"{gate['argmax_equal']['eager']:.2f})")
        recs.append(rec)
    fresh_peak()
    return dict(full=recs, smoke=smoke_graphs(seed))


def graph_cell(cfg, seed: int, dev, tol=None) -> dict:
    """One cell of 6b': ``cfg``'s model from ``seed``, B = 4 prompts of
    ``GRAPH_PROMPT`` tokens prefilled, then ``eager_vs_graph``; both paths
    against the parallel forward (``forward_gap``, gated with ``tol``).
    The MoE's prefill and forward have room for every pair."""
    from repro_torch.models import init_cache, init_params, prefill

    B, S, T = GRAPH_BATCH, GRAPH_PROMPT, LM_DECODE
    dtype = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    base = fresh_peak()
    t0 = time.perf_counter()
    model = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 8)
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), device=dev,
                         generator=gen)
    cache = init_cache(cfg, B, S + T, dtype=dtype, device=dev)
    with room_for_every_pair(model):
        t0 = time.perf_counter()
        first, _ = prefill(cfg, model, {"tokens": toks[:, :S]}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        want = forward_logits(cfg, model, {"tokens": toks}, S)
    eager, graphed, rec = eager_vs_graph(cfg, model, cache, toks[:, S:],
                                         S, S + T)
    rec.update(family=cfg.family, params=cfg.param_count(),
               dtype=cfg.param_dtype, init_s=init_s,
               prefill_ms=prefill_s * 1e3,
               forward=forward_gap(cfg, want, first, eager, graphed, tol=tol),
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               base_gib=base / 2**30)
    del model, cache, eager, graphed, want, first
    fresh_peak()
    return rec


def smoke_graphs(seed: int) -> list:
    """Every causal smoke config (each family: dense, moe, ssm, hybrid,
    vlm) in bf16, captured and replayed on the card: B = 2, prompts of
    ``SMOKE_PROMPT`` tokens (and the vlm's patch embeddings), 16 steps,
    the graph held to eager ``decode_step`` as in 6b."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import init_cache, init_params, prefill

    dev = torch.device(DEVICE, torch.cuda.current_device())
    B, S, T = 2, SMOKE_PROMPT, LM_DECODE
    recs = []
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        if not cfg.causal:
            continue
        model = init_params(cfg, seed, device=dev)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + 9)
        toks = torch.randint(0, cfg.vocab_size, (B, S + T), device=dev,
                             generator=gen)
        batch = {"tokens": toks[:, :S]}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = torch.randn(
                (B, cfg.num_frontend_tokens, cfg.d_model), device=dev,
                generator=gen)
        cache = init_cache(cfg, B, S + T, dtype=torch.bfloat16, device=dev)
        prefill(cfg, model, batch, cache)
        _, _, rec = eager_vs_graph(cfg, model, cache, toks[:, S:], S, S + T)
        rec.update(family=cfg.family)
        recs.append(rec)
        del model, cache
    return recs


# -- phase 7: serving and training with a host failure ---------------------

class TimedCalls:
    """Wraps a function so each call ends in a synchronize and its host time
    is kept (``seconds``)."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = []

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def spread(seconds) -> dict:
    ms = [t * 1e3 for t in seconds]
    return dict(median=statistics.median(ms), min=min(ms), max=max(ms),
                n=len(ms)) if ms else dict(n=0)


def serve_phase(seed: int, cfg, model) -> dict:
    """Phase 7a (see the module docstring): the serving engine over
    ``model`` on the card."""
    from unittest import mock

    from repro_torch.models import embed_inputs, forward_hidden
    from repro_torch.serve import DecodeGraph, Request, ServeEngine
    from repro_torch.serve import engine as engmod

    dev = torch.device(DEVICE, torch.cuda.current_device())
    rng = np.random.default_rng(seed + 70)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=SERVE_NEW, temperature=temp, rid=i)
            for i, (n, temp) in enumerate(SERVE_REQUESTS)]
    steps = sum(max(r.max_new_tokens for r in reqs[c:c + SERVE_SLOTS]) - 1
                for c in range(0, len(reqs), SERVE_SLOTS))
    base = fresh_peak()
    reserved_base = torch.cuda.memory_reserved()
    runs = {}
    # the first engine (capturing its graphs), the same engine again with
    # its sampler reseeded (its graphs and caches reused), then a second
    # engine with the same seed
    for run in ("cold", "warm", "second"):
        if run == "warm":
            eng.gen.manual_seed(seed)
        else:
            eng = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN, seed=seed, device=dev)
        prefill_t = TimedCalls(engmod.prefill)
        replay_t = TimedCalls(DecodeGraph.__call__)
        build_t = TimedCalls(DecodeGraph.__init__)
        with mock.patch.object(engmod, "prefill", prefill_t), \
                mock.patch.object(DecodeGraph, "__call__",
                                  lambda self, *a: replay_t(self, *a)), \
                mock.patch.object(DecodeGraph, "__init__",
                                  lambda self, *a, **k: build_t(self, *a,
                                                                **k)):
            t0 = time.perf_counter()
            outs = eng.generate(reqs)
            wall = time.perf_counter() - t0
        if type(eng.decoder) is not DecodeGraph \
                or eng.decoder.tokens.shape != (SERVE_SLOTS, 1) \
                or len(build_t.seconds) != (run != "warm") \
                or len(replay_t.seconds) != steps:
            raise AssertionError(f"{run}: {len(replay_t.seconds)} graph "
                                 f"replays for {steps} decode steps, "
                                 f"{len(build_t.seconds)} graphs built, "
                                 f"decoder {eng.decoder}")
        runs[run] = dict(outs=outs, wall=wall, prefill_s=prefill_t.seconds,
                         decode_s=replay_t.seconds, build_s=build_t.seconds,
                         capture_ms=eng.decoder.capture_s * 1e3,
                         reserved=torch.cuda.memory_reserved())
    outs, wall = runs["cold"]["outs"], runs["cold"]["wall"]
    if [o.rid for o in outs] != [r.rid for r in reqs] or any(
            len(o.tokens) != r.max_new_tokens
            or not all(0 <= t < cfg.vocab_size for t in o.tokens)
            for o, r in zip(outs, reqs)):
        raise AssertionError("malformed completions")
    for run in ("warm", "second"):
        if [o.tokens for o in runs[run]["outs"]] != [o.tokens for o in outs]:
            raise AssertionError(f"the {run} run drew other tokens than "
                                 f"the first")
    # one replay: kernels and where the device time goes
    full = eng.decoder
    replay_prof = device_profile(lambda: full(full.tokens.clone(),
                                              SERVE_MAX_LEN - 1))
    bound = decode_bound(cfg, model, full.cache, full.tokens,
                         SERVE_MAX_LEN - 1)
    del eng, full
    # each greedy token against the parallel forward over the same padded
    # sequence (the chunk's left padding, the tokens fed before it)
    worst = 0.0
    with torch.no_grad():
        for c0 in range(0, len(reqs), SERVE_SLOTS):
            chunk = list(zip(reqs, outs))[c0:c0 + SERVE_SLOTS]
            plen = max(len(r.prompt) for r, _ in chunk)
            for r, o in chunk:
                if r.temperature > 0:
                    continue
                seq = [0] * (plen - len(r.prompt)) + r.prompt + o.tokens[:-1]
                toks = torch.tensor([seq], dtype=torch.int32, device=dev)
                h = embed_inputs(cfg, model, {"tokens": toks})
                h, _ = forward_hidden(cfg, model, h, positions=torch.arange(
                    len(seq), dtype=torch.int32, device=dev))
                h = model.final_norm(h)
                want = h[0, plen - 1:].float() @ model.embed.table().float().t()
                picked = want.gather(1, torch.tensor(
                    o.tokens, device=dev)[:, None])[:, 0]
                gap = float((want.max(-1).values - picked).max())
                scale = float(want.abs().max())
                worst = max(worst, gap / scale)
                if not torch.isfinite(want).all() or gap > LM_LOGIT_TOL * scale:
                    raise AssertionError(f"request {r.rid}: a greedy token is "
                                         f"{gap} below the forward's largest "
                                         f"logit, over {LM_LOGIT_TOL} x {scale}")
                del h, want
    n_tok = sum(len(o.tokens) for o in outs)
    warm = runs["warm"]
    rec = dict(arch=cfg.name, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
               requests=[dict(rid=r.rid, prompt=len(r.prompt),
                              temperature=r.temperature) for r in reqs],
               new_tokens=SERVE_NEW, tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall,
               prefill_ms=[t * 1e3 for t in runs["cold"]["prefill_s"]],
               decode_ms=spread(runs["cold"]["decode_s"]),
               graph_build_ms=[t * 1e3 for t in runs["cold"]["build_s"]],
               capture_ms=runs["cold"]["capture_ms"],
               warm_wall_s=warm["wall"], tokens_per_s_warm=n_tok / warm["wall"],
               prefill_ms_warm=[t * 1e3 for t in warm["prefill_s"]],
               decode_ms_warm=spread(warm["decode_s"]),
               second_engine_wall_s=runs["second"]["wall"],
               replay_profile=replay_prof, decode_bound=bound,
               greedy_worst_gap=worst, logit_tol=LM_LOGIT_TOL,
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               base_gib=base / 2**30,
               reserved_gib={run: r["reserved"] / 2**30
                             for run, r in runs.items()},
               reserved_base_gib=reserved_base / 2**30)
    log(f"  serve {cfg.name}: {len(reqs)} requests over {SERVE_SLOTS} slots, "
        f"{n_tok} tokens in {wall:.2f} s ({rec['tokens_per_s']:.1f} tokens/s, "
        f"graphs built in " + ", ".join(f"{t:.0f}" for t in
                                        rec["graph_build_ms"])
        + f" ms); reused {warm['wall']:.2f} s "
        f"({rec['tokens_per_s_warm']:.1f} tokens/s); prefill "
        + ", ".join(f"{t:.1f}" for t in rec["prefill_ms"])
        + f" ms a chunk; decode (a replay) median "
        f"{rec['decode_ms']['median']:.2f} ms a step "
        f"({rec['decode_ms']['min']:.1f}-{rec['decode_ms']['max']:.1f}), "
        f"reused {rec['decode_ms_warm']['median']:.2f}; "
        f"{replay_prof['kernels']} kernels a replay at B = {SERVE_SLOTS} "
        f"(bound {bound['bound_ms']:.3f} ms); "
        f"greedy tokens within {worst:.4f} of the forward's largest logit; "
        f"sampled tokens repeat; peak {rec['peak_gib']:.2f} GiB above "
        f"{rec['base_gib']:.2f} GiB; reserved {rec['reserved_base_gib']:.2f} "
        f"GiB before, " + ", ".join(f"{v:.2f}" for v in
                                    rec["reserved_gib"].values())
        + " GiB after each run")
    return rec


@contextlib.contextmanager
def expandable_segments():
    """The allocator's expandable segments, for phase 7b's runs only.  The
    restore needs a 12 GiB block after training has split the cached
    segments: with fixed segments 18.8 GiB sat reserved in them,
    unallocated, and the restore ran out of memory.  In a run that had
    them on throughout, phase 2's kernel events and phase 6's save read
    1.5-2x their times with fixed segments."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def nondeterministic_params(cfg, model, batch) -> list:
    """Names of the parameters whose gradient differs between two backward
    passes over the same microbatch."""
    from repro_torch.models import loss_fn

    grads = []
    for _ in range(2):
        loss_fn(cfg, model, batch).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    return sorted(n for n in grads[0] if not torch.equal(grads[0][n],
                                                          grads[1][n]))


def train_phase(seed: int) -> tuple:
    """Phase 7b (see the module docstring): ``train`` at olmo-1b's full
    width with and without a host failure.  Returns (record, the kernel's
    train-path entry for the ``kernels`` record)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.ft import ECCheckpoint, ErasureCoder
    from repro_torch.ft import checkpoint as ckmod
    from repro_torch.ft.erasure import tree_to_bytes
    from repro_torch.kernels import gf_matmul
    from repro_torch.train import (DataConfig, LoopConfig, OptimizerConfig,
                                   SyntheticLM, train)
    from repro_torch.train import loop as loopmod

    cfg = get_config(TRAIN_ARCH)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    shape_log = ShapeLog(gf_matmul)
    timings = collections.defaultdict(list)

    class TimedCheckpoint(ECCheckpoint):
        """Times save and restore (each ending in a synchronize); with
        ``keep`` set, keeps each saved state's bytes on the host and checks
        a restore against them byte for byte."""
        keep = False

        def save(self, state, step):
            t0 = time.perf_counter()
            super().save(state, step)
            torch.cuda.synchronize()
            timings["save_s"].append(time.perf_counter() - t0)
            if self.keep:
                self.saved = tree_to_bytes(state, device="cpu")[0]

        def restore(self, from_hosts=None):
            t0 = time.perf_counter()
            buf = self.coder.reconstruct(self.group, from_hosts)
            torch.cuda.synchronize()
            timings["restore_s"].append(time.perf_counter() - t0)
            step = 1 << 30
            if buf.shape != self.saved.shape or not all(
                    torch.equal(buf[i:i + step],
                                self.saved[i:i + step].to(buf.device))
                    for i in range(0, len(buf), step)):
                raise AssertionError("the restored state differs from the "
                                     "saved one")
            timings["restored_bytes"].append(len(buf))
            return ckmod.bytes_to_tree(buf, self.spec)

    plan = ckmod.plan_recovery

    def timed_plan(*a, **kw):
        t0 = time.perf_counter()
        out = plan(*a, **kw)
        timings["plan_s"].append(time.perf_counter() - t0)
        return out

    class TimedGraph(loopmod.TrainGraph):
        """Times every call to a synchronize (``seconds``) and keeps what
        it was (``kinds``): the eager first step, a capture and its
        replay, or a replay; ``capture_s`` holds the host seconds of each
        capture and instantiation."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seconds, self.kinds, self.capture_s = [], [], []
            graphs.append(self)

        def _capture(self):
            t0 = time.perf_counter()
            super()._capture()
            self.capture_s.append(time.perf_counter() - t0)

        def __call__(self, batch):
            self.kinds.append("replay" if self.graph is not None else
                              "capture" if self.warm else "eager")
            t0 = time.perf_counter()
            out = super().__call__(batch)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

    graphs = []

    def run(fail_at):
        TimedCheckpoint.keep = bool(fail_at)
        with expandable_segments(), \
                mock.patch.object(loopmod, "TrainGraph", TimedGraph), \
                mock.patch.object(loopmod, "ECCheckpoint", TimedCheckpoint), \
                mock.patch.object(loopmod, "ErasureCoder", lambda **kw:
                                  ErasureCoder(**kw, matmul=shape_log)), \
                mock.patch.object(ckmod, "plan_recovery", timed_plan):
            res = train(cfg, DataConfig(seed=seed, **TRAIN_DATA),
                        OptimizerConfig(), LoopConfig(seed=seed, **TRAIN_LOOP),
                        fail_at=fail_at, scheme="ftr", log=lambda s: None,
                        device=dev)
        graph = graphs.pop()
        if graphs or len(graph.seconds) != res.steps_run:
            raise AssertionError(f"{len(graph.seconds)} calls of "
                                 f"{len(graphs) + 1} train graphs for "
                                 f"{res.steps_run} steps")
        # the times only: the graph holds the run's model and moments
        return res, dict(seconds=graph.seconds, kinds=graph.kinds,
                         capture_s=graph.capture_s)

    log(f"  train {cfg.name} ({cfg.param_count()} {cfg.param_dtype} "
        f"parameters, AdamW fp32 moments): batch {TRAIN_DATA['batch']} x "
        f"{TRAIN_DATA['seq_len']}, {TRAIN_LOOP['n_micro']} microbatches")
    base = fresh_peak()
    launch0 = kernel_launches()
    plain, plain_graph = run({})
    plain_params = {n: t.cpu() for n, t in
                    plain.final_state["params"].state_dict().items()}
    plain_launches = kernel_launches() - launch0
    plain_losses = plain.losses
    del plain
    t_plain = dict(timings)
    timings.clear()
    failed, failed_graph = run(dict(TRAIN_FAIL))
    peak = torch.cuda.max_memory_allocated() - base
    launches = kernel_launches() - launch0
    torch.cuda.synchronize()
    phase_ms = shape_log.ms_by_shape()
    if not (plain_launches > 0 and launches > plain_launches
            and launches == sum(shape_log.shapes.values())):
        raise AssertionError(f"{launches} kernel launches for "
                             f"{sum(shape_log.shapes.values())} products")
    losses = failed.losses
    if not all(math.isfinite(x) for x in losses + plain_losses):
        raise AssertionError("a loss is not finite")
    [(fail_step, host)] = TRAIN_FAIL.items()
    ckpt_step = (fail_step + 1) // TRAIN_LOOP["ckpt_every"] * \
        TRAIN_LOOP["ckpt_every"]
    replay = losses[fail_step + 1:]
    want = plain_losses[ckpt_step:]
    if len(failed.recoveries) != 1 or len(replay) != len(want) or not all(
            abs(a - b) <= TRAIN_RTOL * abs(b) for a, b in zip(replay, want)):
        raise AssertionError(f"replayed losses {replay} differ from the "
                             f"uninterrupted run's {want}")
    if not timings["restored_bytes"]:
        raise AssertionError("the run restored nothing")
    losses_equal = replay == want
    final = failed.final_state["params"].state_dict()
    params_equal = all(torch.equal(final[n].cpu(), plain_params[n])
                       for n in plain_params)
    rec_log = failed.recoveries[0]
    model = failed.final_state["params"]
    del failed.final_state["opt"], plain_params, final
    fresh_peak()
    # which gradients differ between two backward passes of one microbatch,
    # with the default algorithms and with the deterministic ones
    batch = SyntheticLM(DataConfig(seed=seed, **TRAIN_DATA), cfg,
                        device=dev).batch_at(0)
    half = TRAIN_DATA["batch"] // TRAIN_LOOP["n_micro"]
    batch = {k: v[:half] for k, v in batch.items()}
    differ = nondeterministic_params(cfg, model, batch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        differ_det = nondeterministic_params(cfg, model, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    del model, batch, failed
    fresh_peak()
    gates = train_gates(seed)

    tokens = TRAIN_DATA["batch"] * TRAIN_DATA["seq_len"]
    runs = (plain_graph, failed_graph)
    step_s = [t for g in runs for t in g["seconds"]]

    def of_kind(kind):
        return [t for g in runs for t, k in zip(g["seconds"], g["kinds"])
                if k == kind]

    # what the graph costs and saves against the eager step of the gates
    # (tensor-core products, the same shapes, this call): a capture call's
    # excess over a replay, a replay's saving over an eager step, and the
    # steps between two releases at which they even out
    replay_ms = statistics.median(of_kind("replay")) * 1e3
    eager_ms = gates["tensor_cores"]["step_ms"]["median"]
    capture_excess_ms = statistics.median(of_kind("capture")) * 1e3 - \
        replay_ms
    rec = dict(
        arch=cfg.name, source="src/repro/configs/olmo_1b.py:6-10",
        reduced="steps (8), batch (4 x 2048)", params=cfg.param_count(),
        state_bytes=timings["restored_bytes"][0], data=TRAIN_DATA,
        loop=TRAIN_LOOP, fail_at={str(k): v for k, v in TRAIN_FAIL.items()},
        losses=losses, plain_losses=plain_losses,
        replayed_losses_equal=losses_equal,
        final_params_equal=params_equal, nondeterministic_grads=differ,
        nondeterministic_grads_deterministic_algorithms=differ_det,
        step_ms=spread(step_s), tokens_per_s=tokens / statistics.median(
            step_s),
        calls=[g["kinds"] for g in runs],
        replay_ms=spread(of_kind("replay")),
        capture_call_ms=[t * 1e3 for t in of_kind("capture")],
        eager_call_ms=[t * 1e3 for t in of_kind("eager")],
        stepping_s=[sum(g["seconds"]) for g in runs],
        stepping_tokens_per_s=tokens * len(step_s) / sum(step_s),
        eager_stepping_s=[(gates["tensor_cores"]["first_call_ms"]
                           + (len(g["seconds"]) - 1) * eager_ms) / 1e3
                          for g in runs],
        capture_ms=[t * 1e3 for g in runs for t in g["capture_s"]],
        capture_excess_ms=capture_excess_ms,
        replay_saving_ms=eager_ms - replay_ms,
        break_even_steps=capture_excess_ms / (eager_ms - replay_ms)
        if eager_ms > replay_ms else math.inf,
        gates=gates,
        save_s=t_plain["save_s"] + timings["save_s"],
        plan_s=timings["plan_s"], regen_s=rec_log.wall_s,
        execute_s=rec_log.wall_s - timings["plan_s"][-1],
        restore_s=timings["restore_s"], chosen=rec_log.decision.plan.scheme,
        predicted_s=rec_log.decision.predicted_s,
        blocks_moved=rec_log.report.blocks_moved,
        launches=launches, plain_run_launches=plain_launches,
        kernel_ms=sum(phase_ms.values()), peak_gib=peak / 2**30,
        base_gib=base / 2**30)
    log(f"  train: losses {', '.join(f'{x:.4f}' for x in losses)}; host "
        f"{host} failed after step {fail_step}, regenerated with "
        f"{rec['chosen']} in {rec['regen_s']:.3f} s (plan "
        f"{rec['plan_s'][-1]:.4f} s), restored byte for byte in "
        f"{rec['restore_s'][-1]:.3f} s; replayed losses "
        f"{'bitwise equal to' if losses_equal else 'within rtol of'} the "
        f"uninterrupted run's, final parameters "
        f"{'bitwise equal' if params_equal else 'not bitwise equal'}; "
        f"gradients differing between two passes: {differ or 'none'} "
        f"(deterministic algorithms: {differ_det or 'none'})")
    log(f"  train: every call median {rec['step_ms']['median']:.1f} ms "
        f"({rec['step_ms']['min']:.1f}-{rec['step_ms']['max']:.1f}), "
        f"{rec['tokens_per_s']:.0f} tokens/s; replays median "
        f"{rec['replay_ms']['median']:.1f} ms (n {rec['replay_ms']['n']}); "
        "first (eager) calls " + ", ".join(
            f"{t:.0f}" for t in rec["eager_call_ms"]) + " ms; capture calls "
        + ", ".join(f"{t:.0f}" for t in rec["capture_call_ms"])
        + " ms (captures " + ", ".join(f"{t:.0f}" for t in rec["capture_ms"])
        + " ms); stepping " + ", ".join(
            f"{t:.3f}" for t in rec["stepping_s"]) + " s a run, "
        f"{rec['stepping_tokens_per_s']:.0f} tokens/s (eager steps at "
        f"the gates' times: " + ", ".join(
            f"{t:.3f}" for t in rec["eager_stepping_s"]) + " s); a capture "
        f"costs {rec['capture_excess_ms']:.0f} ms over a replay, a replay "
        f"saves {rec['replay_saving_ms']:.1f} ms over an eager step: even "
        f"at {rec['break_even_steps']:.1f} steps between releases; save "
        + ", ".join(f"{t:.3f}" for t in rec["save_s"]) + " s; "
        f"{launches} kernel launches taking {rec['kernel_ms']:.3f} ms; peak "
        f"{rec['peak_gib']:.2f} GiB above {rec['base_gib']:.2f} GiB")

    shapes, total = kernel_at_shapes(shape_log, phase_ms, seed + 7, "train")
    train_kernel = dict(
        run=f"train {cfg.name}", launches=launches, ms=rec["kernel_ms"],
        ms_from_shapes=total["ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"]
        else "bytes", window_ms=total["window_ms"],
        plain_window_ms=total["plain_window_ms"], library_ms=None,
        max_abs_err=0, shapes=shapes)
    return rec, train_kernel


def train_gates(seed: int) -> dict:
    """Phase 7b's step gates (see the module docstring): olmo-1b at fresh
    weights from ``seed``, ``GATE_STEPS`` steps of phase 7b's batches run
    three ways: eagerly with the plain fp32 products
    (``layers.on_tensor_cores`` and ``layers.fused_attention_engages``
    patched to refuse: chunked attention in fp32 products), eagerly with the
    tensor-core products (``EagerTrainStep``), and through a
    ``TrainGraph`` (its first step eager, then a capture and replays);
    then one more step of each profiled (``step_profile``;
    the replay's categories by the eager step's order)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layers
    from repro_torch.obs import spans
    from repro_torch.train import (DataConfig, EagerTrainStep,
                                   OptimizerConfig, SyntheticLM, TrainGraph,
                                   init_opt)

    cfg = get_config(TRAIN_ARCH)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    opt_cfg = OptimizerConfig()
    data = SyntheticLM(DataConfig(seed=seed, **TRAIN_DATA), cfg, device=dev)
    batches = [data.batch_at(i) for i in range(GATE_STEPS + 1)]
    tokens = TRAIN_DATA["batch"] * TRAIN_DATA["seq_len"]

    def run(cls, like=None):
        base = fresh_peak()
        model = init_params(cfg, seed, device=dev)
        runner = cls(cfg, opt_cfg, model, init_opt(opt_cfg, model,
                                                   device=dev),
                     n_micro=TRAIN_LOOP["n_micro"])
        losses, norms, secs = [], [], []
        for batch in batches[:GATE_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = runner(batch)
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(norm)
        # a graph's first call is its eager warm-up step and its second
        # the capture: its steps are the replays after them
        steps = secs[2:] if cls is TrainGraph else secs[1:]
        rec = dict(losses=losses, grad_norms=norms,
                   first_call_ms=secs[0] * 1e3, step_ms=spread(steps),
                   tokens_per_s=tokens / statistics.median(steps),
                   peak_gib=(torch.cuda.max_memory_allocated() - base)
                   / 2**30,
                   reserved_gib=torch.cuda.memory_reserved() / 2**30,
                   base_gib=base / 2**30)
        if cls is TrainGraph:
            rec.update(capture_call_ms=secs[1] * 1e3)
        before = {c: spans.total(c) for c in ATTN_COUNTERS}
        rec["profile"] = step_profile(lambda: runner(batches[GATE_STEPS]),
                                      like=like)
        rec["attention_calls"] = {c: spans.total(c) - before[c]
                                  for c in ATTN_COUNTERS}
        # the profiler slows the host, so the idle share that matters is
        # the busy time's against the unprofiled step
        rec["profile"]["idle_share_of_step"] = (
            1 - rec["profile"]["device_busy_ms"] / rec["step_ms"]["median"])
        runner.release()
        del runner, model, metrics
        fresh_peak()
        return rec

    with mock.patch.object(layers, "on_tensor_cores", lambda *a: False), \
            mock.patch.object(layers, "fused_attention_engages",
                              lambda *a, **kw: False):
        plain = run(EagerTrainStep)
    eager = run(EagerTrainStep)
    graph = run(TrainGraph, like=eager["profile"])
    for rec in (plain, eager, graph):
        if not all(map(math.isfinite, rec["losses"] + rec["grad_norms"])):
            raise AssertionError("a loss or grad norm is not finite")
    for key in ("losses", "grad_norms"):
        if not all(abs(a - b) <= TRAIN_RTOL * abs(b)
                   for a, b in zip(graph[key], eager[key])):
            raise AssertionError(f"the graph's {key} {graph[key]} differ "
                                 f"from the eager step's {eager[key]}")
    gap = abs(eager["losses"][0] - plain["losses"][0])
    tol = PRODUCT_ULPS * bf16_ulp(abs(plain["losses"][0]))
    if gap > tol:
        raise AssertionError(f"the tensor-core loss differs from the fp32 "
                             f"products' by {gap}, over {tol}")
    rel = {key: [abs(a - b) / abs(b) for a, b in zip(eager[key], plain[key])]
           for key in ("losses", "grad_norms")}
    if max(max(v) for v in rel.values()) > PRODUCT_RTOL:
        raise AssertionError(f"the tensor-core step's losses and grad norms "
                             f"differ from the fp32 products' by {rel}, "
                             f"over {PRODUCT_RTOL} of each")
    out = dict(plain_products=plain, tensor_cores=eager, graph=graph,
               graph_bitwise=(graph["losses"] == eager["losses"]
                              and graph["grad_norms"] == eager["grad_norms"]),
               product_loss_gap=gap, product_loss_tol=tol,
               product_rel_gaps=rel)
    for label, rec in (("eager, fp32 products", plain),
                       ("eager, tensor cores", eager), ("replay", graph)):
        log(f"  {label}: step median {rec['step_ms']['median']:.1f} ms, "
            f"{rec['tokens_per_s']:.0f} tokens/s, losses "
            + ", ".join(f"{x:.6f}" for x in rec["losses"]) + ", grad norms "
            + ", ".join(f"{x:.6f}" for x in rec["grad_norms"])
            + f"; peak {rec['peak_gib']:.2f} GiB, reserved "
            f"{rec['reserved_gib']:.2f} GiB")
        log(profile_line(f"  {label} profile", rec["profile"]))
    log(f"  graph against eager: "
        f"{'bitwise equal' if out['graph_bitwise'] else 'within rtol'}; "
        f"tensor-core loss {gap:.3g} from the fp32 products' (gate {tol:g}); "
        f"relative gaps of the losses "
        + ", ".join(f"{x:.3g}" for x in rel["losses"]) + " and grad norms "
        + ", ".join(f"{x:.3g}" for x in rel["grad_norms"])
        + f" (gate {PRODUCT_RTOL:g}); first (eager) call "
        f"{graph['first_call_ms']:.0f} ms, capture call "
        f"{graph['capture_call_ms']:.0f} ms")
    for rec in (plain, eager, graph):
        del rec["profile"]["order"]
    return out


def start_dryruns(root: pathlib.Path, out_dir: pathlib.Path) -> list:
    """Phase 8b's cells, one host process each (``python -m
    repro_torch.launch.dryrun``), started at once: (cell, process, out)."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = out_dir / f"{arch}_{shape}_{int(multi_pod)}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        if multi_pod:
            cmd.append("--multi-pod")
        runs.append(((arch, shape, multi_pod), subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True), out))
    return runs


def finish_dryruns(runs: list) -> list:
    """Wait for phase 8b's processes (killing any past the deadline) and
    check each cell: ``ok``, argument bytes equal to their sum by spec
    arithmetic, counted FLOPs at least the model's, finite roofline terms,
    no CUDA context."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    recs = []
    try:
        for cell, proc, out in runs:
            try:
                _, err = proc.communicate(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dry run {cell} exceeded "
                                     f"{DRYRUN_TIMEOUT} s") from None
            if not out.exists():
                raise AssertionError(f"dry run {cell} wrote nothing: "
                                     f"{err[-2000:]}")
            rec = json.loads(out.read_text())
            if not rec["ok"]:
                raise AssertionError(f"dry run {cell} failed: "
                                     f"{rec['error'][-2000:]}")
            mem = rec["memory"]
            terms = [v for v in rec["roofline"].values()
                     if isinstance(v, float)]
            if mem["argument_bytes"] != mem["analytic_argument_bytes"]:
                raise AssertionError(f"dry run {cell}: argument bytes "
                                     f"{mem['argument_bytes']} != "
                                     f"{mem['analytic_argument_bytes']}")
            if not rec["useful_fraction"] <= 1.0:
                raise AssertionError(f"dry run {cell}: counted FLOPs "
                                     f"{rec['flops_per_device']} below the "
                                     f"model's {rec['model_flops_per_device']}")
            if not all(math.isfinite(v) for v in terms) or \
                    rec["cuda_initialized"]:
                raise AssertionError(f"dry run {cell}: roofline {terms}, "
                                     f"CUDA {rec['cuda_initialized']}")
            recs.append(rec)
            r = rec["roofline"]
            log(f"  dry run {rec['arch']} x {rec['shape']} at {rec['mesh']}: "
                f"{rec['seconds']:.1f} s; arguments "
                f"{mem['argument_bytes'] / 2**30:.2f} GiB (= the specs' "
                f"sum), peak {mem['peak_bytes_per_device'] / 2**30:.2f} GiB "
                f"a device ({mem['peak_fraction_of_hbm']:.2f} of 80 GB); "
                f"{rec['flops_per_device']:.4e} FLOP a device, useful "
                f"{rec['useful_fraction']:.3f}; collectives "
                f"{rec['collective_counts']}; roofline compute "
                f"{r['t_compute']:.3f} s, memory {r['t_memory']:.3f} s, "
                f"links {r['t_collective']:.3f} s ({r['dominant']})")
    finally:
        for _, proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs


def shard_phase(seed: int, root: pathlib.Path) -> dict:
    """Phase 8 (see the module docstring): olmo-1b's train step sharded on
    a 1x1 mesh against the plain step, and the dry run's cells on the
    host."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import (distribute_batch, distribute_model,
                                         param_shardings, set_mesh)
    from repro_torch.launch.mesh import make_host_mesh, teardown
    from repro_torch.models import init_params
    from repro_torch.train import (DataConfig, OptimizerConfig, SyntheticLM,
                                   init_opt, make_train_step)

    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    runs = start_dryruns(root, out_dir)     # host only: they overlap 8a
    try:
        cfg = get_config(TRAIN_ARCH)
        dev = torch.device(DEVICE, torch.cuda.current_device())
        data = SyntheticLM(DataConfig(seed=seed, **TRAIN_DATA), cfg,
                           device=dev)
        batches = [data.batch_at(i) for i in range(SHARD_STEPS)]
        ocfg = OptimizerConfig()
        n_micro = TRAIN_LOOP["n_micro"]

        def run(kind):
            fresh_peak()
            model = init_params(cfg, seed, device=dev)
            mesh = None if kind == "plain" else make_host_mesh(dev)
            try:
                sh = None
                if mesh is not None:
                    sh = param_shardings(mesh, model, fsdp=True)
                    distribute_model(model, mesh, sh)
                step = make_train_step(cfg, ocfg, n_micro=n_micro,
                                       grad_shardings=sh,
                                       gather_weights_once=kind == "gather")
                opt = init_opt(ocfg, model, device=dev)
                metrics, ms = [], []
                with (set_mesh(mesh) if mesh is not None
                      else contextlib.nullcontext()):
                    for b in batches:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if mesh is not None:
                            b = distribute_batch(b, mesh)
                        model, opt, m = step(model, opt, b)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                        metrics.append((float(m["loss"]),
                                        float(m["grad_norm"])))
                final = {n: (p.full_tensor() if mesh is not None else p)
                         .detach().clone()
                         for n, p in model.named_parameters()}
                peak = torch.cuda.max_memory_allocated() / 2**30
                del model, opt, step
                return metrics, final, ms, peak
            finally:
                if mesh is not None:
                    teardown()

        log(f"  sharded step: {cfg.name} at full width, batch "
            f"{TRAIN_DATA['batch']} x {TRAIN_DATA['seq_len']} in {n_micro} "
            f"microbatches, {SHARD_STEPS} steps, 1x1 mesh over NCCL")
        plain, plain_final, plain_ms, plain_peak = run("plain")
        rec = dict(arch=cfg.name, source="src/repro/configs/olmo_1b.py:6-10",
                   steps=SHARD_STEPS, data=TRAIN_DATA, n_micro=n_micro,
                   plain_step_ms=spread([x / 1e3 for x in plain_ms]),
                   plain_peak_gib=plain_peak, plain_metrics=plain)
        for kind in ("shard", "gather"):
            got, final, ms, peak = run(kind)
            ok = all(abs(a - b) <= SHARD_RTOL * abs(b)
                     for g, w in zip(got, plain) for a, b in zip(g, w))
            worst = max(
                float((final[n].float() - w.float()).abs().max())
                / max(float(w.float().abs().max()), 1e-30)
                for n, w in plain_final.items())
            if not ok or worst > SHARD_RTOL:
                raise AssertionError(f"{kind}: metrics {got} against "
                                     f"{plain}, parameters {worst:.3e} of "
                                     f"their scale")
            bitwise = got == plain and all(
                torch.equal(final[n], w) for n, w in plain_final.items())
            rec[kind] = dict(step_ms=spread([x / 1e3 for x in ms]),
                             peak_gib=peak, metrics=got, bitwise=bitwise,
                             param_err_of_scale=worst)
            del final
            log(f"  {kind}: losses and grad norms within rtol "
                f"{SHARD_RTOL} of the plain step "
                f"({'bitwise equal' if bitwise else 'not bitwise'}), "
                f"parameters within {worst:.2e} of their scale; step median "
                f"{rec[kind]['step_ms']['median']:.1f} ms against plain "
                f"{rec['plain_step_ms']['median']:.1f} ms (DTensor's host "
                f"dispatch: {rec[kind]['step_ms']['median'] - rec['plain_step_ms']['median']:+.1f} ms); "
                f"peak {peak:.2f} GiB against {plain_peak:.2f}")
        del plain_final
        torch.cuda.empty_cache()
        rec["dryrun"] = finish_dryruns(runs)
    finally:
        for _, proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the full results here as JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import importlib

    from repro_torch.core import CodeParams
    from repro_torch.kernels import (gf_matmul, gf_matmul_bitmatrix,
                                     gf_matmul_cuda, gf_matmul_ref)
    from repro_torch.storage import RlncSimulator, uniform
    kmod = importlib.import_module("repro_torch.kernels.gf_matmul")
    simmod = importlib.import_module("repro_torch.storage.simulator")
    planned = []                 # (engine, device type) of every repair plan

    def plans_from_batch(res, params):
        planned.append((res.engine, res.times.device.type))
        return core_plans_from_batch(res, params)

    core_plans_from_batch = simmod.plans_from_batch
    simmod.plans_from_batch = plans_from_batch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    results = {"card": card, "seed": args.seed}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, build_out = kmod.build()
    kmod.device_sms(torch.device(DEVICE, torch.cuda.current_device()))
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.2f} s -> {lib_path.name}")
    for line in build_out.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "serialized")):
            log("  ptxas:", line.strip())

    # -- 2. main path: distribute, then one repair per scheme ---------------
    params = CodeParams.msr(**PARAMS)
    M, alpha, k = int(params.M), int(round(params.alpha)), params.k
    shape_log = ShapeLog(gf_matmul)
    launch0 = kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = RlncSimulator(params, block_bytes=BLOCK_BYTES, seed=args.seed,
                        matmul=shape_log)
    torch.cuda.synchronize()
    results["setup_s"] = time.perf_counter() - t0
    file_blocks = sim.file_blocks
    if not (file_blocks.is_cuda and file_blocks.shape == (M, BLOCK_BYTES)
            and all(nd.payload.shape == (alpha, BLOCK_BYTES)
                    and nd.payload.device == file_blocks.device
                    for nd in sim.nodes.values())):
        raise AssertionError("distribute left the store malformed")
    log(f"distribute: {params.n} nodes x {alpha} x {BLOCK_BYTES} B on "
        f"{sim.device}, file {file_blocks.numel() / MIB:.0f} MiB, "
        f"{results['setup_s']:.2f} s with the host draws")

    repairs = []
    for scheme in SCHEMES:
        before = (dict(sim.nodes), sim.np_rng.bit_generator.state,
                  sim.rng.getstate())
        launched = kernel_launches()
        t0 = time.perf_counter()
        [(failed, providers, plan)] = sim.plan_rounds(scheme, uniform(), 1)
        t_plan = time.perf_counter() - t0
        if planned[-1] != ("batched", "cuda"):
            raise AssertionError(f"{scheme}: planned by {planned[-1]}, not "
                                 f"the batched engine on the card")
        t0 = time.perf_counter()
        sim.execute_plan(plan, failed, providers)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t0
        launched = kernel_launches() - launched
        if launched <= 0:
            raise AssertionError(f"{scheme}: the repair launched no kernel")
        newcomer = sim.nodes[failed]
        if newcomer.payload.shape != (alpha, BLOCK_BYTES):
            raise AssertionError(f"{scheme}: newcomer holds "
                                 f"{tuple(newcomer.payload.shape)}")

        others = [i for i in sorted(sim.nodes) if i != failed][:k - 1]
        t0 = time.perf_counter()
        decoded = sim.rl.reconstruct(
            [newcomer] + [sim.nodes[i] for i in others], M)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if not torch.equal(decoded, file_blocks):
            raise AssertionError(f"{scheme}: decoded file differs")
        del decoded

        # the same repair from the same state, with the plain matmul
        np_rng = np.random.default_rng()
        np_rng.bit_generator.state = before[1]
        py_rng = random.Random()
        py_rng.setstate(before[2])
        plain = RlncSimulator.from_state(params, file_blocks, before[0],
                                         np_rng, py_rng, matmul=gf_matmul_ref)
        [(f2, p2, plan2)] = plain.plan_rounds(scheme, uniform(), 1)
        if (f2, p2, plan2.parent) != (failed, providers, plan.parent) or \
                planned[-1] != ("batched", "cuda"):
            raise AssertionError(f"{scheme}: the rerun drew another repair")
        plain.execute_plan(plan2, f2, p2)
        if not (torch.equal(plain.nodes[f2].vectors, newcomer.vectors)
                and torch.equal(plain.nodes[f2].payload, newcomer.payload)):
            raise AssertionError(f"{scheme}: kernel and plain repairs differ")
        del plain

        t0 = time.perf_counter()
        prob = sim.reconstruction_probability(samples=PROB_SAMPLES)
        t_prob = time.perf_counter() - t0
        if not 0.9 <= prob <= 1.0:
            raise AssertionError(f"{scheme}: reconstruction probability {prob}")
        rep = dict(scheme=scheme, failed=failed, plan_time=plan.time,
                   traffic=plan.total_traffic, plan_s=t_plan, execute_s=t_exec,
                   decode_s=t_dec, probability=prob, probability_s=t_prob,
                   repair_launches=launched)
        repairs.append(rep)
        log(f"repair {scheme}: node {failed}, planned time "
            f"{plan.time:.4f} (blocks over link rates), traffic "
            f"{plan.total_traffic:.2f} blocks; "
            f"plan {t_plan:.3f} s, execute {t_exec:.3f} s ({launched} "
            f"launches), decode {t_dec:.3f} s (bitwise), plain rerun equal, "
            f"P(reconstruct) {prob:.4f} over {PROB_SAMPLES} subsets")
    launches = kernel_launches() - launch0
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    torch.cuda.synchronize()
    main_ms = shape_log.ms_by_shape()
    results.update(repairs=repairs, main_path_launches=launches,
                   main_path_kernel_ms=sum(main_ms.values()),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"main path: {launches} kernel launches, "
        f"{sum(shape_log.shapes.values())} GF products taking "
        f"{results['main_path_kernel_ms']} ms between their events, peak "
        f"{results['peak_mem_gib']:.2f} GiB")
    del sim, file_blocks, newcomer, before   # before[0] holds the store
    torch.cuda.empty_cache()

    # -- 3. kernel vs plain: mapping probes, every main-path shape, times ----
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)
    max_err = 0
    n_checked = 0

    def compare(a, b, label):
        nonlocal max_err, n_checked
        got = gf_matmul_cuda(a, b)
        want = gf_matmul_ref(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        max_err = max(max_err, err)
        n_checked += 1
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {label}: max err {err}")
        return got

    mapping_probes(compare, gen)
    main_shapes = sorted(shape_log.shapes, key=lambda s: -s[0] * s[1] * s[2])
    for m, kk, n in main_shapes:
        compare(rand_u8((m, kk), gen), rand_u8((kk, n), gen), (m, kk, n))
        torch.cuda.empty_cache()
    # the plain bit-matrix version (the kernel's algorithm) on the card
    for m, kk, n in [(5, 3, 17), (48, 94, MIB)]:
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        if not torch.equal(gf_matmul_bitmatrix(a, b), gf_matmul_ref(a, b)):
            raise AssertionError(f"plain bit-matrix != plain at {(m, kk, n)}")
    log(f"kernel == plain on {n_checked} products (mapping probes, ragged "
        f"and unaligned shapes, {len(main_shapes)} main-path shapes), max "
        f"abs err {max_err}; plain bit-matrix == plain")

    rows = []
    for m, kk, n in main_shapes:
        a, b = rand_u8((m, kk), gen), rand_u8((kk, n), gen)
        big = n >= MIB
        ms = cuda_ms(lambda: gf_matmul_cuda(a, b), 3 if big else 50)
        plain_ms = cuda_ms(lambda: gf_matmul_ref(a, b), 1 if big else 10)
        t_bytes, t_ops = bound_terms(m, kk, n)
        int8_ms = int8_gemm_ms(a, n, gen) if big and m >= 240 else None
        rows.append(dict(shape=[m, kk, n], calls=shape_log.shapes[(m, kk, n)],
                         main_path_ms=main_ms[(m, kk, n)],
                         ms=ms, plain_ms=plain_ms, int8_gemm_ms=int8_ms,
                         bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes,
                         ops_ms=t_ops,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
        log(f"  {m}x{kk}x{n}: {rows[-1]['calls']} calls, kernel {ms} ms, "
            f"plain {plain_ms} ms, bound {rows[-1]['bound_ms']} ms "
            f"({rows[-1]['bound_by']}), int8 GEMM {int8_ms} ms")
        del a, b
        torch.cuda.empty_cache()

    # `ms` is the main path's own launches, timed by the events around each
    # call; `plain_ms` and `bound_ms` cover the same work as each shape's
    # warm mean (or bound) times the number of calls the main path made at
    # that shape, and `ms_from_shapes` is the kernel's time on that footing.
    # `int8_gemm_ms` is torch._int_mm (cuBLASLt) on the kernel's own
    # bit-matrix product, for the shapes that have it: a yardstick that the
    # port never calls.
    total = {key: sum(r["calls"] * r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    gemm_rows = [r for r in rows if r["int8_gemm_ms"] is not None]
    kernels = [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "matches_plain": max_err == 0,
        "ms": results["main_path_kernel_ms"],
        "ms_from_shapes": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "int8_gemm_ms": sum(r["calls"] * r["int8_gemm_ms"] for r in gemm_rows),
        "int8_gemm_shapes": [r["shape"] for r in gemm_rows],
        "card": card,
        "shapes": rows,
    }]
    kernels.append(attention_phase(args.seed))
    kernels[-1]["card"] = card
    results["kernels"] = kernels

    # -- 4. bulk planning through the tier on the card -----------------------
    log("bulk planning (torch_engine on the card):")
    t0 = time.perf_counter()
    results["planning"] = planning_phase(args.seed)
    results["planning_s"] = time.perf_counter() - t0
    log(f"bulk planning: {results['planning_s']:.1f} s")

    # -- 5. the fleet --------------------------------------------------------
    log("fleet (repro_torch.fleet on the card):")
    t0 = time.perf_counter()
    results["fleet"], kernels[0]["fleet"] = fleet_phase(args.seed, root)
    results["fleet_s"] = time.perf_counter() - t0
    log(f"fleet: {results['fleet_s']:.1f} s")

    # -- 6. checkpoint regeneration and the LM stack at full width ----------
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    log(f"checkpoint regeneration and the LM stack ({FT_ARCH} at full width "
        f"on the card):")
    t0 = time.perf_counter()
    cfg = get_config(FT_ARCH)
    fresh_peak()
    model = init_params(cfg, args.seed, device=DEVICE)
    torch.cuda.synchronize()
    log(f"  init_params: {cfg.param_count()} parameters "
        f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    ft_rec, kernels[0]["ft"] = ft_phase(args.seed, cfg, model)
    results["ft"] = dict(checkpoint=ft_rec, lm=lm_phase(args.seed, cfg, model))
    results["ft_s"] = time.perf_counter() - t0
    log(f"checkpoint and LM: {results['ft_s']:.1f} s")

    # -- 7. serving (the same model), then training with a host failure -----
    log(f"serving {FT_ARCH} and training {TRAIN_ARCH} at full width on the "
        f"card:")
    t0 = time.perf_counter()
    serve_rec = serve_phase(args.seed, cfg, model)
    del model
    t1 = time.perf_counter()
    log(f"the captured decode step at {', '.join(GRAPH_ARCHS)} (full width):")
    results["ft"]["lm_graphs"] = graph_phase(args.seed)
    results["lm_graphs_s"] = time.perf_counter() - t1
    train_rec, kernels[0]["train"] = train_phase(args.seed)
    attention_main_path(kernels[1], train_rec["gates"])
    results["train"] = dict(serve=serve_rec, train=train_rec)
    results["train_s"] = time.perf_counter() - t0
    log(f"serving and training: {results['train_s']:.1f} s")

    # -- 8. sharding: the sharded train step, the dry run ------------------
    log(f"sharding ({TRAIN_ARCH}'s step on a 1x1 mesh on the card; the dry "
        f"run on the host):")
    t0 = time.perf_counter()
    results["shard"] = shard_phase(args.seed, root)
    results["shard_s"] = time.perf_counter() - t0
    log(f"sharding: {results['shard_s']:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    log(json.dumps({"planning": results["planning"]}))
    log(json.dumps({"fleet": results["fleet"]}))
    log(json.dumps({"ft": results["ft"]}))
    log(json.dumps({"train": results["train"]}))
    log(json.dumps({"shard": results["shard"]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
