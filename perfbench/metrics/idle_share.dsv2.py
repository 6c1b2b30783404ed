"""The device's idle share over the traced part of the DeepSeek-V2-Lite
share's window (a save and the replays beside it), as ``idle_share.train``
reads it: one less the union of the trace's device intervals over the
part's length."""


def read(rec, ctx):
    t = rec.trace
    if not t or t.get("window_s", 0) <= 0 or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
