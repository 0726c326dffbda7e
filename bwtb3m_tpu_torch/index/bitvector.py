"""Node bitvectors of the ``.hwt`` file.

The write side of ``bwtb3m_tpu/index/bitvector.py::RankBitVector``
(host numpy), which cannot be imported without JAX (``bwtb3m_tpu/index``
imports its device modules).  The file holds only the bits, so the rank
directory and the queries are not carried over; the run-length variant
(``.rlhwt``) is not ported yet.  Format (FORMATS.md): n as u64, then the
bits LSB-first in little-endian u64 words.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from ..util import serial


class RankBitVector:
    """Plain bitvector, LSB-first in u64 words."""

    def __init__(self, bits: np.ndarray):
        """bits: 0/1 uint8 array."""
        bits = np.asarray(bits, dtype=np.uint8)
        self.n = len(bits)
        nwords = (self.n + 63) // 64
        padded = np.zeros(nwords * 64, dtype=np.uint8)
        padded[: self.n] = bits
        self.words = np.packbits(padded, bitorder="little").view(np.uint64)

    def write(self, f: BinaryIO) -> None:
        serial.write_u64(f, self.n)
        serial.write_u64_array(f, self.words)
