"""Mean milliseconds of a replayed train step of the DeepSeek-V2-Lite
share: CUDA events around each replay call in the window (the batch's copy
and the graph's replay), as ``step_ms`` reads them."""
from perfbench.metrics.step_ms import read  # noqa: F401
