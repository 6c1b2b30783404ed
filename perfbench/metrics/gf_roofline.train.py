"""The GF(2^8) products' share of their roofline in the window's saves:
the sum of each product's least time from its shape
(``roofline.gf_product_bound_s``) over the sum of its CUDA-event time."""
from perfbench import roofline


def read(rec, ctx):
    return roofline.gf_share(rec, ctx)
