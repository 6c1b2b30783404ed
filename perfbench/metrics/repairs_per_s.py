"""Repairs completed over the whole window's time: every repair the window
started, to the end of the last one (host clock, each repair ended by a
synchronize)."""


def read(rec, ctx):
    if not rec.values.get("repairs"):
        return None
    return rec.values["repairs"] / rec.values["window_s"]
