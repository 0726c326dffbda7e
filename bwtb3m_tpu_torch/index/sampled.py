"""Sampled SA / ISA containers.

Port of ``bwtb3m_tpu/index/sampled.py`` (host numpy): libmaus2's
``fm::SampledSA`` / ``fm::SampledISA`` (upstream src/hwtToLCP.cpp:20-21,
85, 113), backed by the ``.sa`` / ``.isa`` files (header: sampling rate,
count, values; the format of upstream src/sasubsample.cpp:35-46).  Values
at unsampled ranks come from the FM index's locate walk
(``index/fm.py``).
"""

from __future__ import annotations

import numpy as np

from ..io import formats


class SampledSA:
    def __init__(self, rate: int, values: np.ndarray, n: int):
        self.rate = rate
        self.values = np.asarray(values, dtype=np.int64)
        self.n = n

    @classmethod
    def load(cls, path: str, n: int) -> "SampledSA":
        rate, values = formats.read_sampled_array(path)
        return cls(rate, values, n)

    def save(self, path: str) -> None:
        formats.write_sampled_array(path, self.rate, self.values)

    def is_sampled(self, r) -> np.ndarray:
        return np.asarray(r) % self.rate == 0

    def get_sampled(self, r) -> np.ndarray:
        return self.values[np.asarray(r) // self.rate]

    def subsample(self, factor: int) -> "SampledSA":
        """Power-of-two subsampling (sasubsample semantics,
        upstream src/sasubsample.cpp:43-58: rate *= s, keep every
        s-th value)."""
        if factor < 1 or (factor & (factor - 1)):
            raise ValueError("subsample factor must be a power of two >= 1")
        return SampledSA(self.rate * factor, self.values[::factor], self.n)


class SampledISA:
    def __init__(self, rate: int, values: np.ndarray, n: int):
        self.rate = rate
        self.values = np.asarray(values, dtype=np.int64)
        self.n = n

    @classmethod
    def load(cls, path: str, n: int) -> "SampledISA":
        rate, values = formats.read_sampled_array(path)
        return cls(rate, values, n)

    def save(self, path: str) -> None:
        formats.write_sampled_array(path, self.rate, self.values)

    def get(self, p) -> np.ndarray:
        """ISA at sampled positions only."""
        p = np.asarray(p)
        if (p % self.rate != 0).any():
            raise ValueError("position not sampled")
        return self.values[p // self.rate]
