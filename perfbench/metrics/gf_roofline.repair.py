"""The GF(2^8) products' share of their roofline in the traced repairs,
measured inside the program: the kernel's dispatcher times each launch
with CUDA events while the profiler records and keeps its shape
(``obs.spans.summary()["products"]``); the sum of each product's least
time from its shape (``roofline.gf_product_bound_s``) over the sum of its
event times.  A program without the dispatcher's events, or a run that
profiled nothing, reads nothing."""
from perfbench import roofline


def read(rec, ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    import torch
    pk = roofline.peaks(torch.cuda.get_device_name(ctx.device))
    products = spans.summary()["products"]
    if pk is None or not products:
        return None
    bound = sum(p["calls"] * roofline.gf_product_bound_s(*p["shape"], pk)
                for p in products)
    took = sum(p["ms"] for p in products) / 1e3
    return 100.0 * bound / took if took > 0 else None
