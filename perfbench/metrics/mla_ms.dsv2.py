"""Mean milliseconds of the MLA blocks' device time in a replay, measured
inside the program: the CUDA events that ``obs.spans.timed("mla")``
captures into the graph around every block's latent attention (its
projections, latent norm, rotary embedding and attention), forward,
recomputation and backward, read after each replay of the traced run.  A
program without the span reads nothing."""
from perfbench.common import mean


def read(rec, ctx):
    m = mean([t for t in rec.samples.get("mla_event_s", []) if t > 0])
    return None if m is None else m * 1e3
