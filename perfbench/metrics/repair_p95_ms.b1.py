"""The 95th percentile, over every repair in the window, of the time from
a node's loss to the newcomer holding its regenerated blocks (plan and
coded bytes moved; host clock to a synchronize)."""
from perfbench.common import p95


def read(rec, ctx):
    v = p95(rec.samples.get("repair_s", []))
    return None if v is None else v * 1e3
