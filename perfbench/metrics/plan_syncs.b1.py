"""Device-to-host reads the planning tier makes in one repair's plan at
B = 1, measured inside the program: the traced counters
``plan.reads.<site>`` of the engine's own sites (those
``core.torch_engine.syncs`` counts: not the profile's reads, nor
``plans_from_batch``'s) over the traced ``plan.many`` spans.  Both cover
only the profiled part of the window; a program without them, or a run
that profiled nothing, reads nothing."""

NOT_THE_ENGINES = ("plan.reads.profile", "plan.reads.unpack")


def read(rec, ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    summary = spans.summary()
    calls = summary["spans"].get("plan.many", {}).get("calls", 0)
    reads = sum(c["traced"] for name, c in summary["counters"].items()
                if name.startswith("plan.reads.")
                and name not in NOT_THE_ENGINES)
    return reads / calls if calls else None
