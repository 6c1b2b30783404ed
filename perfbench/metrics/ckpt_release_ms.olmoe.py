"""Host milliseconds of the expert share's train graph ``release()``
before a save, as ``ckpt_release_ms`` reads them: the program's
``train.release`` span over the traced part of the window."""
from perfbench.metrics.ckpt_release_ms import read  # noqa: F401
