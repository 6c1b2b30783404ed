"""Mean milliseconds of a replayed train step: CUDA events around each
replay call in the window (the batch's copy and the graph's replay)."""
from perfbench.common import mean


def read(rec, ctx):
    m = mean(rec.samples.get("replay_event_s", []))
    return None if m is None else m * 1e3
