"""Percent of the grouped expert products' roofline reached in a replay:
their least time from the held pairs a step (the program's ``moe.pairs``
over the window) and (d, f) (``roofline_moe.expert_products_bound_s``)
over their device time inside the program (``obs.spans.timed(
"moe.products")``'s events, captured into the graph around each grouped
product's forward and backward), both summed over the traced run's
replays."""
from perfbench import roofline, roofline_moe


def read(rec, ctx):
    took = rec.samples.get("products_event_s", [])
    pairs = rec.values.get("pairs_per_step")
    if not took or not pairs or ctx.device.type != "cuda":
        return None
    import torch
    pk = roofline.peaks(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    cfg = ctx.config
    model = cfg["model"]
    calls = model["num_layers"] * cfg["n_micro"]
    passes = 2 if model.get("remat", True) else 1
    bound = roofline_moe.expert_products_bound_s(model, pairs, calls,
                                                 passes, pk)
    return 100.0 * bound * len(took) / sum(took)
