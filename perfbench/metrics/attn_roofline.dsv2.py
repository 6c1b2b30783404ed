"""Percent of the MLA attention's roofline reached in a replay: the least
time of the step's attention calls (``roofline_mla.attention_bound_s``:
causal QK^T, dQ and dK at the query-key width, PV, dP and dV at the value
width, each forward pass under remat and the backward, at 989e12, or their
bytes, whichever is larger) over their device time inside the program
(``obs.spans.timed("attn.mla")``'s events, captured into the graph around
each call, forward, recomputation and backward), both summed over the
traced run's replays.  A program without the span reads nothing."""
from perfbench import roofline, roofline_mla


def read(rec, ctx):
    took = [t for t in rec.samples.get("attn_mla_event_s", []) if t > 0]
    if not took or ctx.device.type != "cuda":
        return None
    import torch
    pk = roofline.peaks(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    cfg = ctx.config
    model = cfg["model"]
    calls = model["num_layers"] * cfg["n_micro"]
    passes = 2 if model.get("remat", True) else 1
    bound = roofline_mla.attention_bound_s(
        model, cfg["batch"] // cfg["n_micro"], cfg["seq_len"], calls, passes,
        pk)
    return 100.0 * bound * len(took) / sum(took)
