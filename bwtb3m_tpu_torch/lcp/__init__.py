"""PLCP and LCP: ``lcpbit``, ``hwtToLCP`` and ``checkLCPBit``'s modules
(port of ``bwtb3m_tpu/lcp``)."""

from .plcp import (PLCPBitDecoder, compute_plcp, decode_plcp_bits,
                   encode_plcp_bits)
from .rmm import RMMTree

__all__ = [
    "PLCPBitDecoder",
    "compute_plcp",
    "encode_plcp_bits",
    "decode_plcp_bits",
    "RMMTree",
]
