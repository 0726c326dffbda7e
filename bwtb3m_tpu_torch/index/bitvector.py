"""Rank-indexed bitvectors: the node bitvectors of ``.hwt`` and ``.rlhwt``.

Port of ``bwtb3m_tpu/index/bitvector.py`` (host numpy, as there): a plain
bitvector with a superblock rank directory, and a run-length-compressed
variant, the roles of libmaus2's rank bitvectors and of the
``rank::RunLengthBitVectorGenerator`` of upstream src/hwtToRlHwt.cpp:110-117.
Formats in FORMATS.md; all words little-endian u64.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from ..util import serial

_SUPER = 512  # bits per rank superblock (8 words)

# popcount table for u16 halves
_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)], dtype=np.uint16)


def _popcount_u64(words: np.ndarray) -> np.ndarray:
    w = words.view(np.uint64)
    return (
        _POP16[(w & np.uint64(0xFFFF)).astype(np.int64)].astype(np.int64)
        + _POP16[((w >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.int64)]
        + _POP16[((w >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.int64)]
        + _POP16[((w >> np.uint64(48)) & np.uint64(0xFFFF)).astype(np.int64)]
    )


class RankBitVector:
    """Plain bitvector (LSB-first in u64 words) + superblock rank counts.

    The rank directory is built at the first query, vectorized: the
    ``.hwt`` writer of a genome build packs billions of bits and queries
    none of them."""

    def __init__(self, bits: np.ndarray):
        """bits: 0/1 uint8 array."""
        bits = np.asarray(bits, dtype=np.uint8)
        self.n = len(bits)
        nwords = (self.n + 63) // 64
        padded = np.zeros(nwords * 64, dtype=np.uint8)
        padded[: self.n] = bits
        packed_bytes = np.packbits(padded, bitorder="little")
        self.words = packed_bytes.view(np.uint64)
        self._super = None

    @classmethod
    def from_words(cls, n: int, words: np.ndarray) -> "RankBitVector":
        """The bitvector of ``n`` bits already packed: ``words`` holds
        ceil(n / 64) u64 words, LSB-first, the bits past n 0."""
        words = np.asarray(words).view(np.uint64)
        if len(words) != (n + 63) // 64:
            raise ValueError("%d bits take %d words, got %d"
                             % (n, (n + 63) // 64, len(words)))
        bv = cls.__new__(cls)
        bv.n, bv.words, bv._super = int(n), words, None
        return bv

    def _directory(self):
        """(superblock prefix counts, total ones), built once."""
        if self._super is None:
            wps = _SUPER // 64
            nsuper = (self.n + _SUPER - 1) // _SUPER + 1
            pc = _popcount_u64(self.words)
            per = np.zeros(nsuper, dtype=np.int64)
            full = np.zeros(-(-len(pc) // wps) * wps, dtype=np.int64)
            full[:len(pc)] = pc
            per[1:1 + len(full) // wps] = full.reshape(-1, wps).sum(1)
            self._super = (np.cumsum(per), int(pc.sum()))
        return self._super

    @property
    def super_counts(self) -> np.ndarray:
        return self._directory()[0]

    @property
    def total_ones(self) -> int:
        return self._directory()[1]

    def get(self, i):
        """Bit(s) at position(s) i."""
        i = np.asarray(i, dtype=np.int64)
        return ((self.words[i >> 6] >> (i & 63).astype(np.uint64)) & np.uint64(1)).astype(np.int64)

    def rank1(self, i):
        """Number of 1 bits in [0, i). Vectorized over i."""
        i = np.asarray(i, dtype=np.int64)
        scalar = i.ndim == 0
        i = np.atleast_1d(i)
        s = i // _SUPER
        base = self.super_counts[s]
        wps = _SUPER // 64
        w0 = s * wps
        wi = i >> 6
        # whole words between superblock start and i's word
        out = base.copy()
        # add popcounts of words [w0, wi)
        maxw = len(self.words)
        for off in range(wps):
            wj = w0 + off
            mask = wj < wi
            valid = wj < maxw
            sel = mask & valid
            if sel.any():
                out[sel] += _popcount_u64(self.words[wj[sel]])
        # partial word
        rem = (i & 63).astype(np.uint64)
        has_partial = (rem > 0) & (wi < maxw)
        if has_partial.any():
            w = self.words[np.where(has_partial, wi, 0)]
            masked = w & ((np.uint64(1) << rem) - np.uint64(1))
            out += np.where(has_partial, _popcount_u64(masked), 0)
        return out[0] if scalar else out

    def rank0(self, i):
        i = np.asarray(i, dtype=np.int64)
        return i - self.rank1(i)

    # ---- serialization --------------------------------------------------
    def write(self, f: BinaryIO) -> None:
        serial.write_u64(f, self.n)
        serial.write_u64_array(f, self.words.view(np.uint64))

    @classmethod
    def read(cls, f: BinaryIO) -> "RankBitVector":
        n = serial.read_u64(f)
        nwords = (n + 63) // 64
        words = serial.read_u64_array(f, nwords)
        bits = np.unpackbits(
            words.astype("<u8").view(np.uint8), bitorder="little"
        )[:n]
        return cls(bits)


class RLBitVector:
    """Run-length-compressed bitvector with rank support.

    Stores alternating run lengths (starting with a 0-run, possibly empty)
    plus prefix tables; rank is two searchsorteds. Role of the per-node
    run-length bitvectors of the rlhwt format
    (upstream src/hwtToRlHwt.cpp:89-151).
    """

    def __init__(self, bits: np.ndarray):
        bits = np.asarray(bits, dtype=np.uint8)
        self.n = len(bits)
        if self.n == 0:
            self.run_ends = np.zeros(0, dtype=np.int64)
            self.one_prefix = np.zeros(1, dtype=np.int64)
            self.first_bit = 0
            self.total_ones = 0
            return
        starts = np.concatenate([[0], np.flatnonzero(bits[1:] != bits[:-1]) + 1])
        lens = np.diff(np.concatenate([starts, [self.n]]))
        self.first_bit = int(bits[0])
        self.run_ends = np.cumsum(lens)            # end position of each run
        vals = (np.arange(len(lens)) % 2 == 0)
        ones = np.where(vals == (self.first_bit == 1), lens, 0)
        self.one_prefix = np.concatenate([[0], np.cumsum(ones)])
        self.total_ones = int(self.one_prefix[-1])

    def rank1(self, i):
        i = np.asarray(i, dtype=np.int64)
        scalar = i.ndim == 0
        i = np.atleast_1d(i).clip(0, self.n)
        if self.n == 0:
            out = np.zeros_like(i)
            return out[0] if scalar else out
        r = np.searchsorted(self.run_ends, i, side="left")
        r = np.minimum(r, len(self.run_ends) - 1)
        run_start = np.where(r > 0, self.run_ends[r - 1], 0)
        run_bit = ((r % 2 == 0) == (self.first_bit == 1)).astype(np.int64)
        out = self.one_prefix[r] + run_bit * (i - run_start)
        return out[0] if scalar else out

    def rank0(self, i):
        i = np.asarray(i, dtype=np.int64)
        return np.clip(i, 0, self.n) - self.rank1(i)

    def get(self, i):
        i = np.asarray(i, dtype=np.int64)
        r = np.searchsorted(self.run_ends, i, side="right")
        return ((r % 2 == 0) == (self.first_bit == 1)).astype(np.int64)

    # ---- serialization --------------------------------------------------
    def write(self, f: BinaryIO) -> None:
        serial.write_u64(f, self.n)
        serial.write_u8(f, self.first_bit)
        serial.write_u64(f, len(self.run_ends))
        serial.write_u64_array(f, self.run_ends.astype("<u8"))

    @classmethod
    def read(cls, f: BinaryIO) -> "RLBitVector":
        n = serial.read_u64(f)
        first_bit = serial.read_u8(f)
        nruns = serial.read_u64(f)
        run_ends = serial.read_u64_array(f, nruns).astype(np.int64)
        obj = cls.__new__(cls)
        obj.n = n
        obj.first_bit = first_bit
        obj.run_ends = run_ends
        lens = np.diff(np.concatenate([[0], run_ends]))
        vals = (np.arange(len(lens)) % 2 == 0)
        ones = np.where(vals == (first_bit == 1), lens, 0)
        obj.one_prefix = np.concatenate([[0], np.cumsum(ones)])
        obj.total_ones = int(obj.one_prefix[-1])
        return obj
