"""Host milliseconds of the train graph's ``release()`` before a save (its
pool freed with ``empty_cache``), measured inside the program: the
``train.release`` span's mean over the traced part of the window (one
save).  A program without the span, or a run that profiled nothing,
reads nothing."""


def read(rec, ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    release = spans.summary()["spans"].get("train.release")
    if not release or not release["calls"]:
        return None
    return release["ms"] / release["calls"]
