"""Mean milliseconds of a checkpoint save in the window: the graph's
release and ``ECCheckpoint.save`` (the state's bytes and their encode),
host clock to a synchronize."""
from perfbench.common import mean


def read(rec, ctx):
    m = mean(rec.samples.get("save_s", []))
    return None if m is None else m * 1e3
