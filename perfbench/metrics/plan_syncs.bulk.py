"""Device-to-host reads the planning tier makes in one bulk call
(``core.torch_engine.syncs``, the program's counter), mean over the
window's calls."""
from perfbench.common import mean


def read(rec, ctx):
    return mean(rec.samples.get("call_syncs", []))
