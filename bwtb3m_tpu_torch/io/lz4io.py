"""LZ4 block-compressed byte streams with a block index.

Role of the reference's ``lz::Lz4CompressStream`` + index
(upstream src/bytestreamToLz4.cpp:33-45, consumed via
``inputtype=lz4``). The container here is our own documented "LZ4B" format
(FORMATS.md); the per-block payload is the standard public LZ4 *block*
format (token / literals / offset / matchlen sequences), implemented from
the public specification — no lz4 library is available in this environment.

    header:  magic b"LZ4B", u8 version, u32 block_size, u64 n (raw bytes),
             u64 footer_off
    blocks:  u32 csize, u32 usize, payload[csize]
    footer:  u64 block_off[nb]

Compression is greedy hash-chain (pure Python; adequate for the CLI tool —
a native codec can replace it transparently).
"""

from __future__ import annotations

import struct

import numpy as np

from ..util import serial

MAGIC = b"LZ4B"
DEFAULT_BLOCK = 1 << 16
MIN_MATCH = 4


def lz4_compress_block(src: bytes) -> bytes:
    """Compress one block to the LZ4 block format (greedy). Uses the
    native C++ codec when available."""
    from .. import native
    nat = native.lz4_compress(src)
    if nat is not None:
        return nat
    n = len(src)
    out = bytearray()
    table = {}
    anchor = 0
    i = 0
    # last 5 bytes must be literals; matches must not start in last 12 bytes
    limit = n - 12
    while i <= limit:
        key = src[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend match
            m = 4
            maxm = n - 5 - i
            while m < maxm and src[cand + m] == src[i + m]:
                m += 1
            lit = src[anchor:i]
            _emit_sequence(out, lit, i - cand, m)
            i += m
            anchor = i
        else:
            i += 1
    # trailing literals
    lit = src[anchor:]
    _emit_literals_only(out, lit)
    return bytes(out)


def _emit_len(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _emit_sequence(out: bytearray, lit: bytes, offset: int, mlen: int) -> None:
    ll = len(lit)
    ml = mlen - MIN_MATCH
    token = (min(ll, 15) << 4) | min(ml, 15)
    out.append(token)
    if ll >= 15:
        _emit_len(out, ll - 15)
    out.extend(lit)
    out.extend(struct.pack("<H", offset))
    if ml >= 15:
        _emit_len(out, ml - 15)


def _emit_literals_only(out: bytearray, lit: bytes) -> None:
    ll = len(lit)
    out.append(min(ll, 15) << 4)
    if ll >= 15:
        _emit_len(out, ll - 15)
    out.extend(lit)


def lz4_decompress_block(src: bytes, usize: int) -> bytes:
    """Decompress one LZ4 block (public block format). Uses the native
    C++ codec when available."""
    from .. import native
    nat = native.lz4_decompress(src, usize)
    if nat is not None:
        return nat
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        out.extend(src[i : i + ll])
        i += ll
        if i >= n:
            break  # last sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        ml = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset beyond start")
        for j in range(ml):  # byte-wise: matches may overlap themselves
            out.append(out[start + j])
    if len(out) != usize:
        raise ValueError("LZ4 block decoded to %d bytes, expected %d" % (len(out), usize))
    return bytes(out)


def write_lz4_stream(path: str, data: bytes, block_size: int = DEFAULT_BLOCK) -> None:
    n = len(data)
    nb = max(1, (n + block_size - 1) // block_size)
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u8(f, 1)
        serial.write_u32(f, block_size)
        serial.write_u64(f, n)
        footer_pos = f.tell()
        serial.write_u64(f, 0)
        offsets = np.zeros(nb, dtype=np.uint64)
        for b in range(nb):
            offsets[b] = f.tell()
            chunk = data[b * block_size : (b + 1) * block_size]
            comp = lz4_compress_block(chunk)
            serial.write_u32(f, len(comp))
            serial.write_u32(f, len(chunk))
            f.write(comp)
        footer_off = f.tell()
        serial.write_u64_array(f, offsets)
        f.seek(footer_pos)
        serial.write_u64(f, footer_off)


def read_lz4_stream(path: str) -> bytes:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("not an LZ4B file: %s" % path)
        serial.read_u8(f)
        block_size = serial.read_u32(f)
        n = serial.read_u64(f)
        serial.read_u64(f)
        nb = max(1, (n + block_size - 1) // block_size)
        out = bytearray()
        for _ in range(nb):
            csize = serial.read_u32(f)
            usize = serial.read_u32(f)
            out.extend(lz4_decompress_block(f.read(csize), usize))
    return bytes(out)
