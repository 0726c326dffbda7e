"""Compact (k-bit packed) arrays — the text format of the suite.

Behavioural equivalent of the reference's ``bitio::CompactArray`` /
``CompactArrayWriterFile`` (upstream src/fagzToCompact.cpp:85 writes a
3-bit stream; fagzToCompact4 a 2-bit one; digitsToCompact a 4-bit one;
decodecompact reads any of them back). The reference's exact on-disk layout
lives in libmaus2 (not vendored), so this framework defines its own documented
format, "CAR1" (see FORMATS.md):

    magic   4 bytes  b"CAR1"
    bits    u8       bits per symbol (1..16)
    n       u64      number of symbols
    payload ceil(n*bits/8) bytes, symbols packed LSB-first

Packing is LSB-first within each byte: symbol i occupies bit positions
[i*bits, (i+1)*bits) of the bit stream, where bit j of the stream is byte
j>>3, bit j&7.
"""

from __future__ import annotations

from typing import BinaryIO, Tuple

import numpy as np

from ..util import serial

MAGIC = b"CAR1"


def pack_bits(symbols: np.ndarray, bits: int) -> np.ndarray:
    """Pack int symbols (< 2**bits) into a uint8 byte array, LSB-first."""
    symbols = np.asarray(symbols)
    n = symbols.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    sym = symbols.astype(np.uint32)
    # bit matrix [n, bits], LSB first
    shifts = np.arange(bits, dtype=np.uint32)
    bitmat = ((sym[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def unpack_bits(data: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns int32 symbols."""
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    raw = np.unpackbits(np.asarray(data, dtype=np.uint8), bitorder="little")
    raw = raw[: n * bits].reshape(n, bits).astype(np.int32)
    weights = (1 << np.arange(bits, dtype=np.int32))
    return raw @ weights


def write_compact(path: str, symbols: np.ndarray, bits: int) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u8(f, bits)
        serial.write_u64(f, len(symbols))
        f.write(pack_bits(symbols, bits).tobytes())


def read_compact_header(f: BinaryIO) -> Tuple[int, int]:
    magic = f.read(4)
    if magic != MAGIC:
        raise ValueError("not a CAR1 compact array file (magic=%r)" % magic)
    bits = serial.read_u8(f)
    n = serial.read_u64(f)
    return bits, n


def read_compact(path: str) -> Tuple[np.ndarray, int]:
    """Read a compact file. Returns (symbols int32, bits)."""
    with open(path, "rb") as f:
        bits, n = read_compact_header(f)
        nbytes = (n * bits + 7) // 8
        data = np.frombuffer(f.read(nbytes), dtype=np.uint8)
    return unpack_bits(data, bits, n), bits


def compact_length(path: str) -> int:
    with open(path, "rb") as f:
        _bits, n = read_compact_header(f)
    return n


class CompactArrayWriter:
    """Streaming writer (reference ``CompactArrayWriterFile`` analog).

    Buffers symbols and flushes whole-byte-aligned chunks; call ``close()``
    to finalize the header's n.
    """

    FLUSH_SYMBOLS = 1 << 20

    def __init__(self, path: str, bits: int):
        self.path = path
        self.bits = bits
        self.n = 0
        self._buf = []
        self._carry = np.zeros(0, dtype=np.int64)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        serial.write_u8(self._f, bits)
        serial.write_u64(self._f, 0)  # patched in close()
        # flush in units whose bit-count is byte aligned
        self._align = 8 // np.gcd(8, bits)

    def put(self, symbols: np.ndarray) -> None:
        symbols = np.asarray(symbols, dtype=np.int64)
        self.n += len(symbols)
        if len(self._carry):
            symbols = np.concatenate([self._carry, symbols])
            self._carry = np.zeros(0, dtype=np.int64)
        keep = (len(symbols) // self._align) * self._align
        if keep:
            self._f.write(pack_bits(symbols[:keep], self.bits).tobytes())
        self._carry = symbols[keep:]

    def put_one(self, symbol: int) -> None:
        self.put(np.array([symbol], dtype=np.int64))

    def close(self) -> None:
        if self._f is None:
            return
        if len(self._carry):
            self._f.write(pack_bits(self._carry, self.bits).tobytes())
            self._carry = np.zeros(0, dtype=np.int64)
        self._f.seek(5)
        serial.write_u64(self._f, self.n)
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
