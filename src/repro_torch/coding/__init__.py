"""GF(2^w) arithmetic and random linear network coding (paper Section II)."""
from .gf import GF, GF8, GF16, GF8_POLY, GF16_POLY
from .rlnc import CodedBlocks, RLNC, independent_rows

__all__ = ["GF", "GF8", "GF16", "GF8_POLY", "GF16_POLY", "CodedBlocks",
           "RLNC", "independent_rows"]
