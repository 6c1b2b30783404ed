"""Overlays planned over the whole window's time (every call's batch,
host clock, each call ended by a synchronize)."""


def read(rec, ctx):
    if not rec.values.get("plans"):
        return None
    return rec.values["plans"] / rec.values["window_s"]
