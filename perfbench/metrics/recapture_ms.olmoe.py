"""Milliseconds the first train step of the expert share after a save
costs over a replay, as ``recapture_ms`` reads them: the mean host time
of the calls that capture the graph again, less the mean replay call."""
from perfbench.metrics.recapture_ms import read  # noqa: F401
