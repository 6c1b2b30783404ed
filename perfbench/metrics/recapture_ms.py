"""Milliseconds the first train step after a save costs over a replay:
the mean host time of the calls that capture the graph again, less the
mean replay call (host clock to the loss's read)."""
from perfbench.common import mean


def read(rec, ctx):
    cap = mean(rec.samples.get("capture_call_s", []))
    rep = mean(rec.samples.get("replay_host_s", []))
    if cap is None or rep is None:
        return None
    return (cap - rep) * 1e3
