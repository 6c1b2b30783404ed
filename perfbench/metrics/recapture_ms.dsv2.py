"""Milliseconds the first train step of the DeepSeek-V2-Lite share after a
save costs over a replay, as ``recapture_ms`` reads them: the mean host
time of the calls that capture the graph again, less the mean replay
call."""
from perfbench.metrics.recapture_ms import read  # noqa: F401
