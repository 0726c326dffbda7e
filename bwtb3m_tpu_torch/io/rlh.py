"""Huffman-coded run-length BWT files ("RLH1") — the compressed .bwt codec.

Closest analog of the reference's actual .bwt encoding
(``huffman::RLEncoder``: Huffman-coded (sym, runlength) runs in indexed
blocks — upstream src/bwtb3mdecoderl.cpp:19; the exact libmaus2
bit layout is not recoverable, SURVEY.md caveat). Format (FORMATS.md):

    header:  magic RLH1 | version u8 | flags u8 | sigma u32 | n u64 |
             block_size u32 | footer_off u64
    table:   nsyms u32 | nsyms x (sym u32, codelen u8)   (canonical)
    blocks:  nruns u32 | nbits u32 | payload bits (LSB-first bytes):
             per run, canonical-Huffman code of sym (MSB-first) then
             Elias-gamma of the run length
    footer:  block_off u64[nb] | cum_counts u64[(nb+1)*sigma]

Encoding is vectorized numpy (bit scatter at cumsum offsets); decoding
uses the native C++ canonical decoder with a Python fallback. Typical
size: ~40-60% of the byte-aligned RLB1 format on DNA BWTs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..index.huffman import HuffmanTree
from ..util import serial
from .bits import pack_bitstream, unpack_bitstream
from .rl import DEFAULT_BLOCK, _run_starts

MAGIC = b"RLH1"


def _encode_runs_bits(syms: np.ndarray, lens: np.ndarray,
                      codes: np.ndarray, clens: np.ndarray) -> Tuple[np.ndarray, int]:
    """Vectorized bit emission: huffman(sym) + gamma(len) per run."""
    hlen = clens[syms]
    v = lens.astype(np.uint64)
    nlen = np.floor(np.log2(v.astype(np.float64))).astype(np.int64)
    nlen = np.where((np.uint64(1) << nlen.astype(np.uint64)) > v, nlen - 1, nlen)
    nlen = np.where((np.uint64(2) << nlen.astype(np.uint64)) <= v, nlen + 1, nlen)
    glen = 2 * nlen + 1
    total_per = hlen + glen
    starts = np.concatenate([[0], np.cumsum(total_per)])
    total = int(starts[-1])
    bits = np.zeros(total, dtype=np.uint8)
    # huffman bits, MSB-first
    maxh = int(hlen.max()) if len(hlen) else 0
    code = codes[syms]
    for j in range(maxh):
        sel = hlen > j
        shift = (hlen[sel] - 1 - j).astype(np.int64)
        bits[starts[:-1][sel] + j] = (code[sel] >> shift) & 1
    # gamma: nlen zeros then value bits MSB-first at offset hlen + nlen + j
    maxn = int(nlen.max()) if len(nlen) else 0
    for j in range(maxn + 1):
        sel = nlen >= j
        shift = (nlen[sel] - j).astype(np.uint64)
        bits[starts[:-1][sel] + hlen[sel] + nlen[sel] + j] = (
            (v[sel] >> shift) & np.uint64(1)).astype(np.uint8)
    return bits, total


def rlh_encode(path: str, symbols: np.ndarray, sigma: int = None,
               block_size: int = DEFAULT_BLOCK) -> None:
    symbols = np.asarray(symbols)
    n = int(len(symbols))
    if sigma is None:
        sigma = int(symbols.max()) + 1 if n else 1
    hist = np.bincount(symbols, minlength=sigma) if n else np.zeros(1, np.int64)
    if n:
        tree = HuffmanTree({int(s): int(c) for s, c in enumerate(hist) if c})
        codes, clens = tree.code_arrays(max(sigma, max(tree.symbols) + 1))
        tree_syms = tree.symbols
    else:
        # empty input: no Huffman tree (nsyms=0 in the header), mirroring
        # rl_encode's clean n==0 handling
        tree = None
        codes = np.zeros(max(1, sigma), dtype=np.uint64)
        clens = np.zeros(max(1, sigma), dtype=np.uint8)
        tree_syms = []
    nb = max(1, (n + block_size - 1) // block_size)

    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u8(f, 1)
        serial.write_u8(f, 0)
        serial.write_u32(f, sigma)
        serial.write_u64(f, n)
        serial.write_u32(f, block_size)
        footer_pos = f.tell()
        serial.write_u64(f, 0)
        serial.write_u32(f, len(tree_syms))
        for s in tree_syms:
            serial.write_u32(f, int(s))
            serial.write_u8(f, tree.length[s])

        starts = _run_starts(symbols)
        bounds = np.arange(0, n, block_size, dtype=np.int64)
        all_starts = np.union1d(starts, bounds) if n else bounds
        all_ends = np.concatenate([all_starts[1:], [n]])
        rlens = all_ends - all_starts
        rsyms = symbols[all_starts] if n else np.zeros(0, symbols.dtype)
        run_block = all_starts // block_size if n else np.zeros(0, np.int64)
        rbb = np.searchsorted(run_block, np.arange(nb + 1))

        block_off = np.zeros(nb, dtype=np.uint64)
        cum = np.zeros((nb + 1, sigma), dtype=np.uint64)
        running = np.zeros(sigma, dtype=np.uint64)
        for b in range(nb):
            block_off[b] = f.tell()
            lo, hi = rbb[b], rbb[b + 1]
            bs, bl = rsyms[lo:hi].astype(np.int64), rlens[lo:hi]
            bits, nbits = _encode_runs_bits(bs, bl, codes, clens)
            serial.write_u32(f, int(hi - lo))
            serial.write_u32(f, nbits)
            f.write(pack_bitstream(bits))
            cum[b] = running
            if hi > lo:
                np.add.at(running, bs, bl.astype(np.uint64))
        cum[nb] = running
        footer_off = f.tell()
        serial.write_u64_array(f, block_off)
        serial.write_u64_array(f, cum.reshape(-1))
        f.seek(footer_pos)
        serial.write_u64(f, footer_off)


class RLHReader:
    """Reader with the same core surface as RLReader (decode/rank/hist)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        if self._f.read(4) != MAGIC:
            raise ValueError("not an RLH1 file: %s" % path)
        serial.read_u8(self._f)
        serial.read_u8(self._f)
        self.sigma = serial.read_u32(self._f)
        self.n = serial.read_u64(self._f)
        self.block_size = serial.read_u32(self._f)
        self.footer_off = serial.read_u64(self._f)
        nsyms = serial.read_u32(self._f)
        lengths = {}
        for _ in range(nsyms):
            s = serial.read_u32(self._f)
            lengths[s] = serial.read_u8(self._f)
        if lengths:
            self.tree = HuffmanTree.from_lengths(lengths)
            order = sorted(self.tree.symbols,
                           key=lambda s: (self.tree.length[s], s))
            self.canon_syms = np.array(order, dtype=np.uint32)
            self.canon_lens = np.array([self.tree.length[s] for s in order],
                                       dtype=np.uint8)
        else:  # empty .bwt (n == 0): no code table
            self.tree = None
            self.canon_syms = np.zeros(0, dtype=np.uint32)
            self.canon_lens = np.zeros(0, dtype=np.uint8)
        self.nb = max(1, (self.n + self.block_size - 1) // self.block_size)
        self._f.seek(self.footer_off)
        self.block_off = serial.read_u64_array(self._f, self.nb)
        self.cum_counts = serial.read_u64_array(
            self._f, (self.nb + 1) * self.sigma).reshape(self.nb + 1, self.sigma)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def get_length(path: str) -> int:
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not an RLH1 file: %s" % path)
            f.read(2)
            serial.read_u32(f)
            return serial.read_u64(f)

    def _read_block_runs(self, b: int):
        self._f.seek(int(self.block_off[b]))
        nruns = serial.read_u32(self._f)
        nbits = serial.read_u32(self._f)
        payload = self._f.read((nbits + 7) // 8)
        from .. import native
        nat = native.rlh_decode_runs(payload, nbits, nruns,
                                     self.canon_syms, self.canon_lens)
        if nat is not None:
            return nat[0].astype(np.int32), nat[1]
        # Python fallback
        bits = unpack_bitstream(payload, nbits)
        syms = np.zeros(nruns, np.int32)
        lens = np.zeros(nruns, np.int64)
        i = 0
        code_map = {(self.tree.length[s], self.tree.code[s]): s
                    for s in self.tree.symbols}
        for k in range(nruns):
            code, l = 0, 0
            while True:
                code = (code << 1) | int(bits[i]); i += 1; l += 1
                if (l, code) in code_map:
                    syms[k] = code_map[(l, code)]
                    break
            nz = 0
            while bits[i] == 0:
                nz += 1; i += 1
            v = 0
            for _ in range(nz + 1):
                v = (v << 1) | int(bits[i]); i += 1
            lens[k] = v
        return syms, lens

    def decode_block(self, b: int) -> np.ndarray:
        syms, lens = self._read_block_runs(b)
        return np.repeat(syms, lens)

    def decode_all(self) -> np.ndarray:
        if self.n == 0:
            return np.zeros(0, np.int32)
        return np.concatenate([self.decode_block(b) for b in range(self.nb)])

    def symbol_histogram(self) -> np.ndarray:
        return self.cum_counts[self.nb].copy()

    def rank(self, c: int, i: int) -> int:
        if i <= 0:
            return 0
        i = min(i, self.n)
        b = i // self.block_size
        if b >= self.nb:
            return int(self.cum_counts[self.nb][c])
        base = int(self.cum_counts[b][c])
        rem = i - b * self.block_size
        if rem == 0:
            return base
        blk = self.decode_block(b)
        return base + int(np.count_nonzero(blk[:rem] == c))


def rlh_decode(path: str) -> np.ndarray:
    with RLHReader(path) as r:
        return r.decode_all()
