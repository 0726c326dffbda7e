"""Binary serialization primitives.

Behavioural equivalents of the reference's ``NumberSerialisation`` /
``NumberMapSerialisation`` (used e.g. by upstream src/bwtdecodeblock.cpp
for the ``.hist`` symbol-frequency map). All multi-byte integers in this
framework's formats are little-endian, 64-bit unless stated otherwise; every
format is documented in FORMATS.md at the repo root.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict

import numpy as np

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
_U8 = struct.Struct("<B")


def write_u64(f: BinaryIO, v: int) -> None:
    f.write(_U64.pack(v))


def read_u64(f: BinaryIO) -> int:
    return _U64.unpack(f.read(8))[0]


def write_u32(f: BinaryIO, v: int) -> None:
    f.write(_U32.pack(v))


def read_u32(f: BinaryIO) -> int:
    return _U32.unpack(f.read(4))[0]


def write_u16(f: BinaryIO, v: int) -> None:
    f.write(_U16.pack(v))


def read_u16(f: BinaryIO) -> int:
    return _U16.unpack(f.read(2))[0]


def write_u8(f: BinaryIO, v: int) -> None:
    f.write(_U8.pack(v))


def read_u8(f: BinaryIO) -> int:
    return _U8.unpack(f.read(1))[0]


def write_u64_array(f: BinaryIO, arr: np.ndarray) -> None:
    f.write(np.ascontiguousarray(arr, dtype="<u8").tobytes())


def read_u64_array(f: BinaryIO, count: int) -> np.ndarray:
    return np.frombuffer(f.read(8 * count), dtype="<u8").astype(np.uint64)


def write_number_map(f: BinaryIO, m: Dict[int, int]) -> None:
    """Serialized sorted (key, value) u64 pair map — behavioural analog of
    the reference's ``NumberMapSerialisation::serialiseMap``."""
    keys = sorted(m.keys())
    write_u64(f, len(keys))
    for k in keys:
        write_u64(f, int(k))
        write_u64(f, int(m[k]))


def read_number_map(f: BinaryIO) -> Dict[int, int]:
    count = read_u64(f)
    out: Dict[int, int] = {}
    for _ in range(count):
        k = read_u64(f)
        v = read_u64(f)
        out[k] = v
    return out
