"""The whole train step's share of the card's bf16 peak: the model's
FLOPs a step (``roofline.train_step_flops``) over the mean replay's device
time (CUDA events), against 989 TFLOP/s."""
from perfbench import roofline
from perfbench.common import mean


def read(rec, ctx):
    t = mean(rec.samples.get("replay_event_s", []))
    if t is None or ctx.device.type != "cuda":
        return None
    import torch
    pk = roofline.peaks(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    tr = ctx.config
    flops = roofline.train_step_flops(ctx.config["model"],
                                      tr["batch"] * tr["seq_len"],
                                      tr["seq_len"])
    return 100.0 * flops / t / pk["bf16_flops"]
