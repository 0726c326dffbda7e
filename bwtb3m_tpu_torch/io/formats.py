"""Sidecar file formats: .hist, .preisa, .sa, .isa, .meta.

The reference's bwtb3m emits ``.bwt`` + ``.hist`` + ``.meta`` + ``.preisa``
(+ ``.sa``/``.isa``/``.hwt`` when bwtonly=0) — file set per reference README
"Output" and the consumers upstream src/checkbwt.cpp:33-53,
upstream src/hwtPreIsaToIsa.cpp:39-43.

Formats here (FORMATS.md):

* ``.hist``   — u64 entry count, then sorted (u64 symbol, u64 count) pairs
                (behavioural analog of NumberMapSerialisation).
* ``.preisa`` — (u64 rank, u64 position) pairs, raw LE; ``.preisa.meta`` holds
                u64 samplingrate, u64 count.
* ``.sa`` / ``.isa`` — u64 samplingrate, u64 count, then count u64 values.
                This layout matches what the reference tools themselves
                read/write: upstream src/sasubsample.cpp:35-58 and
                upstream src/bwttestdecodespeed.cpp:40-41 (rate, count,
                values as consecutive 64-bit words).
* ``.meta``   — JSON manifest of the construction run (the reference's binary
                .meta is a libmaus2 internal; ours is documented JSON).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from ..util import serial


# ---------------------------------------------------------------- .hist

def write_hist(path: str, counts: Dict[int, int]) -> None:
    with open(path, "wb") as f:
        serial.write_number_map(f, {k: v for k, v in counts.items() if v})


def read_hist(path: str) -> Dict[int, int]:
    with open(path, "rb") as f:
        return serial.read_number_map(f)


def hist_from_array(arr: np.ndarray) -> Dict[int, int]:
    return {int(s): int(c) for s, c in enumerate(arr) if c}


# ---------------------------------------------------------------- .preisa

def write_preisa(path: str, ranks: np.ndarray, positions: np.ndarray,
                 samplingrate: int) -> None:
    assert len(ranks) == len(positions)
    pairs = np.empty((len(ranks), 2), dtype="<u8")
    pairs[:, 0] = ranks
    pairs[:, 1] = positions
    with open(path, "wb") as f:
        f.write(pairs.tobytes())
    with open(path + ".meta", "wb") as f:
        serial.write_u64(f, samplingrate)
        serial.write_u64(f, len(ranks))


def read_preisa(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (ranks, positions, samplingrate)."""
    raw = np.fromfile(path, dtype="<u8").reshape(-1, 2)
    try:
        with open(path + ".meta", "rb") as f:
            rate = serial.read_u64(f)
    except FileNotFoundError:
        rate = 0
    return raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64), rate


# ---------------------------------------------------------------- .sa / .isa

def write_sampled_array(path: str, samplingrate: int, values: np.ndarray) -> None:
    with open(path, "wb") as f:
        serial.write_u64(f, samplingrate)
        serial.write_u64(f, len(values))
        serial.write_u64_array(f, values.astype("<u8"))


def read_sampled_array(path: str) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        rate = serial.read_u64(f)
        count = serial.read_u64(f)
        values = serial.read_u64_array(f, count).astype(np.int64)
    return rate, values


# ---------------------------------------------------------------- .meta

def write_meta(path: str, meta: dict) -> None:
    with open(path, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")


def read_meta(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
