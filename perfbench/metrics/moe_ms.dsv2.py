"""Mean milliseconds of the DeepSeekMoE layers' device time in a replay
(the routed share and the shared experts), measured inside the program:
the CUDA events that ``obs.spans.timed("moe")`` captures into the graph
around every MoE layer's forward, recomputation and backward, read after
each replay of the traced run."""
from perfbench.common import mean


def read(rec, ctx):
    m = mean(rec.samples.get("moe_event_s", []))
    return None if m is None else m * 1e3
