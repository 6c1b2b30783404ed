"""Tokens of the train steps completed in the window over the time from
the window's start to the end of the last of them, the saves and the
graph's captures after them included (host clock)."""


def read(rec, ctx):
    if not rec.values.get("tokens"):
        return None
    return rec.values["tokens"] / rec.values["window_s"]
