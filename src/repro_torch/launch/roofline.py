"""Roofline terms and ring-model link bytes for the dry run on NVIDIA H100s
(the counterpart of ``repro.launch.hlo_analysis``'s ``roofline_terms`` and
its ring formulas; its HLO parser has no torch input and is not ported).

Per-device link bytes of one collective over a group of n devices, with
``size`` the bytes named below (the ring algorithms):

    all-reduce       2 (n-1)/n * size      (size = output bytes)
    all-gather         (n-1)/n * size      (size = output bytes)
    reduce-scatter     (n-1)/n * size * n  (size = output bytes)
    all-to-all         (n-1)/n * size
    permute                  1 * size

Hardware model: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data
sheet (dense rates): 989e12 FLOP/s in bf16, 3.35e12 B/s of HBM, and 450e9
B/s a direction over NVLink (18 links of 25 GB/s) within a host of 8
cards.  The production meshes do not fit in one host: 16x16 spans 32 such
hosts and 2x16x16 64, so a group that leaves a host crosses the
inter-host network, which is slower than NVLink and is not modelled here
(no figure for it is known to this code).  The link term is therefore a
lower bound on the time of any collective whose group spans hosts.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM
HBM_BW = 3.35e12        # bytes/s
LINK_BW = 450e9         # bytes/s a direction, NVLink within a host
HBM_BYTES = 80e9        # device memory

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "permute")


def link_bytes(kind: str, size: float, n: int) -> float:
    """Per-device link bytes of one collective of ``kind`` over ``n``
    devices moving ``size`` bytes (see the module docstring)."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * size
    if kind in ("all-gather", "all-to-all"):
        return frac * size
    if kind == "reduce-scatter":
        return frac * size * n
    if kind == "permute":
        return float(size)
    raise ValueError(f"unknown collective {kind!r}; expected one of {KINDS}")


def roofline_terms(flops: float, hbm_bytes: float, link_bytes: float,
                   ) -> Dict[str, float]:
    """The three times of one device's step and which one bounds it:
    ``t_compute`` (FLOPs over the bf16 peak), ``t_memory`` (bytes over
    the HBM rate), ``t_collective`` (link bytes over NVLink's rate, a
    lower bound across hosts), ``dominant``, ``bound_s`` (their max) and
    ``roofline_fraction`` (t_compute over the bound)."""
    t_comp = flops / PEAK_FLOPS
    t_mem = hbm_bytes / HBM_BW
    t_coll = link_bytes / LINK_BW
    terms = {"t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["bound_s"] = bound
    terms["roofline_fraction"] = (t_comp / bound) if bound > 0 else 0.0
    return terms
