#!/usr/bin/env python3
"""Where the planning tier's time goes, on one NVIDIA card.

    python3 scripts/planning_variants.py [--seed N] [--out results.json]

Plans the Fig. 7 deployment (MSR n=20, k=5, d=10, M=8000, links U[10,120],
B = 4096 overlays) with ``repro_torch.core.torch_engine`` and times the
schemes that bisect (ftr, shah, and fr at the Fig. 8 interior point)
with ``_SPEC_LEVELS``, the bisection levels evaluated per oracle call (1 is
plain bisection), varied in turns (forward, then backward).  Every variant
must give the default's parents and times within 1e-9.  Then one profiled
plan of each scheme at the engine's own constants (``torch.profiler``, CPU
and CUDA activities): the device's busy time (the sum of the kernels' own
device time), kernel launches and device reads, the wall time around that
profiled plan, and beside it the mean unprofiled time of the same scheme at
the same constants from the turns above.

Prints the card and one line per measurement; the last line is a JSON
object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N, K, D, M = 4096, 20, 5, 10, 8000.0
VARIANTS = [dict(_SPEC_LEVELS=L) for L in (1, 2, 3, 4)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("planning_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.core import torch_engine as te

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(args.seed)
    caps = rng.uniform(10.0, 120.0, size=(B, D + 1, D + 1))
    caps[:, np.arange(D + 1), np.arange(D + 1)] = 0.0
    caps = torch.from_numpy(caps).to("cuda")
    msr = core.CodeParams.msr(n=N, k=K, d=D, M=M)
    a_mbr, _ = core.mbr_point(M, K, D)
    interior = core.CodeParams(n=N, k=K, d=D, M=M,
                               alpha=M / K + 0.5 * (a_mbr - M / K))
    cells = [("ftr", msr), ("shah", msr), ("fr", interior)]
    default = {name: getattr(te, name) for name in VARIANTS[0]}
    if default not in VARIANTS:
        raise AssertionError(f"the engine's constants {default} are not "
                             f"among the variants")

    def run(scheme, params):
        s0 = te.syncs
        t0 = time.perf_counter()
        res = core.plan_many(caps, params, scheme)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, te.syncs - s0

    want = {}
    for scheme, params in cells:
        run(scheme, params)                                   # warm-up
        want[scheme] = run(scheme, params)[0]
    rows = []
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            for name, value in v.items():
                setattr(te, name, value)
            for scheme, params in cells:
                res, ms, syncs = run(scheme, params)
                ref = want[scheme]
                if not (torch.equal(res.parents, ref.parents) and torch.allclose(
                        res.times, ref.times, rtol=1e-9, atol=1e-9)):
                    raise AssertionError(f"{v} planned {scheme} otherwise")
                rows.append(dict(scheme=scheme, ms=ms, syncs=syncs, **v))
                print(f"{scheme} {v}: {ms:.1f} ms, {syncs} device reads",
                      flush=True)
    for name, value in default.items():
        setattr(te, name, value)

    profiles = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for scheme, params in cells:
        with torch.profiler.profile(activities=acts) as prof:
            _, ms, syncs = run(scheme, params)
        busy_us, launches = 0.0, 0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                busy_us += dev_us
                launches += e.count
        same = [r["ms"] for r in rows if r["scheme"] == scheme
                and all(r[n] == v for n, v in default.items())]
        profiles.append(dict(scheme=scheme, wall_ms=ms, syncs=syncs,
                             device_busy_ms=busy_us / 1e3,
                             kernel_launches=launches,
                             busy_share=busy_us / 1e3 / ms,
                             unprofiled_ms=sum(same) / len(same),
                             **default))
        print(f"profiled {scheme} {default}: wall {ms:.1f} ms, device busy "
              f"{busy_us / 1e3:.1f} ms ({launches} kernels, {syncs} device "
              f"reads); unprofiled {profiles[-1]['unprofiled_ms']:.1f} ms",
              flush=True)
    out = {"card": card, "B": B, "variants": rows, "profiles": profiles,
           "defaults": default}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
