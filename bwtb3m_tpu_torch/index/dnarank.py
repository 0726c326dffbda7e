"""DNARank: 2-bit packed BWT with occ checkpoints (.dnarank files).

Port of ``bwtb3m_tpu/index/dnarank.py`` (host numpy): libmaus2's
``rank::DNARank`` / ``DNARank256`` (upstream src/bwttodnarank.cpp:34-36
and bwttodnarank256.cpp), the BWA-style occ-table rank structure over a
4-symbol BWT with 64- or 256-symbol-aligned superblocks.  The bytes
equal the reference's (tests/test_torch_index.py).  Format "DNR1"
(FORMATS.md):

    magic   4B   b"DNR1"
    block   u32  symbols per checkpoint block (64 or 256)
    n       u64
    occ     u64[(nb+1)*4]   counts before each block (+ total row)
    data    2-bit packed symbols, 4/byte LSB-first, padded to blocks
"""

from __future__ import annotations

import numpy as np

from ..util import serial

MAGIC = b"DNR1"

# per-byte symbol counts: _BYTE_COUNTS[b, c] = #occurrences of c in byte b
_shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
_b = np.arange(256, dtype=np.uint16)
_codes = (_b[:, None] >> _shifts[None, :]) & 3
_BYTE_COUNTS = np.stack(
    [(_codes == c).sum(axis=1) for c in range(4)], axis=1
).astype(np.int64)  # [256, 4]


class DNARank:
    def __init__(self, symbols: np.ndarray, block: int = 64):
        symbols = np.asarray(symbols, dtype=np.uint8)
        if len(symbols) and symbols.max() > 3:
            raise ValueError("DNARank requires a 4-symbol alphabet BWT")
        if block % 4 != 0:
            raise ValueError("block must be a multiple of 4")
        self.n = len(symbols)
        self.block = block
        nb = (self.n + block - 1) // block
        pad = nb * block - self.n
        padded = np.concatenate([symbols, np.zeros(pad, np.uint8)])
        quads = padded.reshape(-1, 4)
        self.data = (
            quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
        ).astype(np.uint8)
        per_block = np.zeros((nb, 4), dtype=np.int64)
        bpb = block // 4
        byte_counts = _BYTE_COUNTS[self.data]  # [nbytes, 4]
        per_block = byte_counts.reshape(nb, bpb, 4).sum(axis=1)
        if pad:
            # remove the padding zeros counted as symbol 0
            per_block[-1, 0] -= pad
        self.occ = np.concatenate(
            [np.zeros((1, 4), np.int64), np.cumsum(per_block, axis=0)]
        )

    def symbol(self, i):
        i = np.asarray(i, dtype=np.int64)
        return ((self.data[i >> 2] >> ((i & 3) * 2)) & 3).astype(np.int64)

    def rank(self, c: int, i) -> np.ndarray:
        """Count of symbol c in [0, i); vectorized over i."""
        i = np.asarray(i, dtype=np.int64)
        scalar = i.ndim == 0
        i = np.atleast_1d(i).clip(0, self.n)
        b = i // self.block
        base = self.occ[b, c]
        out = base.copy()
        # bytes fully inside [block start, i)
        byte0 = b * (self.block // 4)
        bi = i >> 2
        for off in range(self.block // 4):
            wj = byte0 + off
            sel = wj < bi
            if sel.any():
                out[sel] += _BYTE_COUNTS[self.data[wj[sel]], c]
        rem = i & 3
        has_partial = rem > 0
        if has_partial.any():
            byte = self.data[np.where(has_partial, bi, 0)]
            cnt = np.zeros(len(i), dtype=np.int64)
            for j in range(3):
                cnt += ((byte >> (2 * j)) & 3 == c) & (j < rem)
            out += np.where(has_partial, cnt, 0)
        return out[0] if scalar else out

    # ---- serialization --------------------------------------------------
    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(MAGIC)
            serial.write_u32(f, self.block)
            serial.write_u64(f, self.n)
            serial.write_u64_array(f, self.occ.reshape(-1).astype("<u8"))
            f.write(self.data.tobytes())

    @classmethod
    def read(cls, path: str) -> "DNARank":
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not a DNR1 file: %s" % path)
            block = serial.read_u32(f)
            n = serial.read_u64(f)
            nb = (n + block - 1) // block
            occ = serial.read_u64_array(f, (nb + 1) * 4).astype(np.int64).reshape(nb + 1, 4)
            data = np.frombuffer(f.read(nb * block // 4), dtype=np.uint8)
        obj = cls.__new__(cls)
        obj.n = n
        obj.block = block
        obj.occ = occ
        obj.data = data
        return obj

    @classmethod
    def from_run_length(cls, bwt_path: str, block: int = 64) -> "DNARank":
        """``DNARank::loadFromRunLength`` equivalent
        (upstream src/bwttodnarank.cpp:34)."""
        from ..io.rl import rl_decode

        return cls(rl_decode(bwt_path).astype(np.uint8), block=block)
