"""Seconds from the process's start to the window's start: imports, the
card's context, the kernel library, data and weights, warm-up and any
compilation (host clock, to a synchronize)."""


def read(rec, ctx):
    return ctx.setup_s
