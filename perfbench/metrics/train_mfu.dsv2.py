"""The whole step's share of the card's bf16 peak: the model's FLOPs a
step (``roofline_mla.train_step_flops``: the dense products, the held
experts' pairs counted by the program's ``moe.pairs`` over the window,
causal attention at its query-key and value widths) over the mean
replay's device time (CUDA events), against 989 TFLOP/s."""
from perfbench import roofline, roofline_mla
from perfbench.common import mean


def read(rec, ctx):
    t = mean(rec.samples.get("replay_event_s", []))
    pairs = rec.values.get("pairs_per_step")
    if t is None or not pairs or ctx.device.type != "cuda":
        return None
    import torch
    pk = roofline.peaks(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    cfg = ctx.config
    flops = roofline_mla.train_step_flops(
        cfg["model"], cfg["batch"] * cfg["seq_len"], cfg["seq_len"], pairs)
    return 100.0 * flops / t / pk["bf16_flops"]
