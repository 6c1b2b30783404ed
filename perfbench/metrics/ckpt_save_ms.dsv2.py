"""Mean milliseconds of a checkpoint save of the DeepSeek-V2-Lite share's
state in the window: the graph's release and ``ECCheckpoint.save``, host
clock to a synchronize, as ``ckpt_save_ms`` reads them."""
from perfbench.metrics.ckpt_save_ms import read  # noqa: F401
