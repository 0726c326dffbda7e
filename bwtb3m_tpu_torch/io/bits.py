"""Bit-stream primitives and Elias-gamma coding.

Role of the reference's ``bitio::BitVectorInput/Output`` and
``gamma::Gamma*Encoder/Decoder`` families (used between lcpbit phases,
upstream src/lcpbit.cpp:22-27). Encoding is vectorized numpy
(scatter set-bits at cumsum positions); decoding uses the native C++
codec when available with a pure-Python fallback.

Bit order: LSB-first within bytes, matching every other format here.
Gamma code for v >= 1: N = floor(log2 v) zeros, then the N+1 bits of v
most-significant-first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pack_bitstream(bits: np.ndarray) -> bytes:
    """0/1 uint8 array -> bytes (LSB-first)."""
    return np.packbits(np.asarray(bits, np.uint8), bitorder="little").tobytes()


def unpack_bitstream(data: bytes, nbits: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8),
                         bitorder="little")[:nbits]


def gamma_encode(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """Elias-gamma encode positive ints. Returns (bit array uint8, nbits)."""
    v = np.asarray(values, dtype=np.uint64)
    if len(v) == 0:
        return np.zeros(0, np.uint8), 0
    if (v < 1).any():
        raise ValueError("gamma coding requires values >= 1")
    nlen = np.floor(np.log2(v.astype(np.float64))).astype(np.int64)
    # fix float edge cases near powers of two
    nlen = np.where((np.uint64(1) << nlen.astype(np.uint64)) > v, nlen - 1, nlen)
    nlen = np.where((np.uint64(2) << nlen.astype(np.uint64)) <= v, nlen + 1, nlen)
    lens = 2 * nlen + 1
    starts = np.concatenate([[0], np.cumsum(lens)])
    total = int(starts[-1])
    bits = np.zeros(total, dtype=np.uint8)
    # value bits: bit j (MSB-first) of v goes at starts + nlen + j
    maxn = int(nlen.max())
    for j in range(maxn + 1):
        sel = nlen >= j
        shift = (nlen[sel] - j).astype(np.uint64)
        bitvals = ((v[sel] >> shift) & np.uint64(1)).astype(np.uint8)
        pos = starts[:-1][sel] + nlen[sel] + j
        bits[pos] = bitvals
    return bits, total


def gamma_decode(bits: np.ndarray, count: int) -> np.ndarray:
    """Decode `count` gamma codes from a 0/1 array (Python fallback)."""
    out = np.zeros(count, dtype=np.uint64)
    i = 0
    nb = len(bits)
    for k in range(count):
        n = 0
        while i < nb and bits[i] == 0:
            n += 1
            i += 1
        v = 0
        for _ in range(n + 1):
            v = (v << 1) | int(bits[i])
            i += 1
        out[k] = v
    return out


class GammaFile:
    """Simple gamma-coded integer stream file: magic GAM1, count u64,
    nbits u64, packed bits."""

    MAGIC = b"GAM1"

    @classmethod
    def write(cls, path: str, values: np.ndarray) -> None:
        from ..util import serial
        bits, nbits = gamma_encode(values)
        with open(path, "wb") as f:
            f.write(cls.MAGIC)
            serial.write_u64(f, len(values))
            serial.write_u64(f, nbits)
            f.write(pack_bitstream(bits))

    @classmethod
    def read(cls, path: str) -> np.ndarray:
        from ..util import serial
        with open(path, "rb") as f:
            if f.read(4) != cls.MAGIC:
                raise ValueError("not a GAM1 file: %s" % path)
            count = serial.read_u64(f)
            nbits = serial.read_u64(f)
            bits = unpack_bitstream(f.read(), nbits)
        from .. import native
        nat = native.gamma_decode(bits, count)
        if nat is not None:
            return nat
        return gamma_decode(bits, count)
