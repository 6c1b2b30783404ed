"""The GF(2^8) products' share of their roofline in the saves of the
DeepSeek-V2-Lite share's state, as ``gf_roofline.train`` reads it: the sum
of each product's least time from its shape over the sum of its CUDA-event
time."""
from perfbench import roofline


def read(rec, ctx):
    return roofline.gf_share(rec, ctx)
