"""The device's idle share over the traced part of the window: one less
the union of every device interval in ``torch.profiler``'s trace over the
part's length (host clock, between synchronizes)."""


def read(rec, ctx):
    t = rec.trace
    if not t or t.get("window_s", 0) <= 0 or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
