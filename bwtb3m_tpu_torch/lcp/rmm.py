"""Range-minimum tree over the LCP array (``.rmm`` files).

Port of ``bwtb3m_tpu/lcp/rmm.py`` (host numpy), the role of libmaus2's
``rmq::RMMTree`` that the reference's hwtToLCP builds: RMQ support over
LCP for suffix-tree navigation, as a power-of-two segment tree of
minima.  Format "RMM1" (FORMATS.md): magic, n, then the level arrays
from the leaves up, each u64-serialized.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..util import serial

MAGIC = b"RMM1"


class RMMTree:
    def __init__(self, values: np.ndarray):
        values = np.asarray(values, dtype=np.int64)
        self.n = len(values)
        self.levels: List[np.ndarray] = [values.copy()]
        cur = values
        while len(cur) > 1:
            if len(cur) % 2:
                cur = np.concatenate([cur, [np.iinfo(np.int64).max]])
            cur = cur.reshape(-1, 2).min(axis=1)
            self.levels.append(cur)

    def rmq(self, l: int, r: int) -> Tuple[int, int]:
        """(min value, index of leftmost minimum) over values[l:r]."""
        if not (0 <= l < r <= self.n):
            raise ValueError("bad rmq range [%d, %d) for n=%d" % (l, r, self.n))
        best = np.iinfo(np.int64).max
        # two-pointer over levels
        lo, hi = l, r
        lev = 0
        segs = []
        while lo < hi:
            if lo % 2 == 1:
                segs.append((lev, lo))
                lo += 1
            if hi % 2 == 1:
                hi -= 1
                segs.append((lev, hi))
            lo //= 2
            hi //= 2
            lev += 1
        for lev_i, idx in segs:
            v = int(self.levels[lev_i][idx])
            if v < best:
                best = v
        # find leftmost index achieving best
        idx = int(np.flatnonzero(self.levels[0][l:r] == best)[0]) + l
        return best, idx

    # ---- serialization --------------------------------------------------
    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(MAGIC)
            serial.write_u64(f, self.n)
            serial.write_u64(f, len(self.levels))
            for lev in self.levels:
                serial.write_u64(f, len(lev))
                serial.write_u64_array(f, lev.astype("<u8"))

    @classmethod
    def read(cls, path: str) -> "RMMTree":
        obj = cls.__new__(cls)
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not an RMM1 file: %s" % path)
            obj.n = serial.read_u64(f)
            nlev = serial.read_u64(f)
            obj.levels = []
            for _ in range(nlev):
                ln = serial.read_u64(f)
                obj.levels.append(serial.read_u64_array(f, ln).astype(np.int64))
        return obj
