"""Huffman-shaped wavelet tree (``.hwt``), the file ``bwtb3m`` writes
with ``bwtonly=0``.

The write side of ``bwtb3m_tpu/index/wavelet.py::HuffmanWaveletTree``
(host numpy), which cannot be imported without JAX (``bwtb3m_tpu/index``
imports its device modules); the queries, the reader and the ``.rlhwt``
variant are not ported yet.  Output is byte-identical to the reference
package's (tests/test_torch_pipeline.py).

File format (FORMATS.md):

    HWT1:
      magic      4B    b"HWT1"
      n          u64   sequence length
      nsyms      u32
      (sym u32, codelen u8, count u64) * nsyms   -- canonical Huffman spec
      node blobs in node-id order (RankBitVector serialization)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..util import serial

from .bitvector import RankBitVector
from .huffman import HuffmanTree

MAGIC = b"HWT1"
BUILD_CHUNK = 1 << 24     # symbols coded at a time by ``build``
# up to this many inner nodes ``build`` scans the text once per node
# (``_node_bits``: DNA has 3); past it once per level (``_level_bits``:
# thousands of nodes, 10-20 levels)
PER_NODE_MAX = 16


class HuffmanWaveletTree:
    """Plain-bitvector Huffman wavelet tree (.hwt)."""

    def __init__(self, tree: HuffmanTree, n: int, nodes):
        self.tree = tree
        self.n = n
        self.nodes = nodes  # list of bitvectors, index = trie node id

    @classmethod
    def build(cls, symbols: np.ndarray, hist: Optional[Dict[int, int]] = None):
        symbols = np.asarray(symbols)
        if hist is None:
            if symbols.dtype == np.uint8:
                cnt = sum(np.bincount(symbols[a:a + BUILD_CHUNK],
                                      minlength=256)
                          for a in range(0, len(symbols), BUILD_CHUNK))
                uniq = np.flatnonzero(cnt)
                cnt = cnt[uniq]
            else:
                uniq, cnt = np.unique(symbols, return_counts=True)
            hist = {int(s): int(c) for s, c in zip(uniq, cnt)}
        tree = HuffmanTree(hist)
        sigma = int(max(tree.symbols)) + 1
        codes, lengths = tree.code_arrays(sigma)
        # node prefixes/depths from the trie
        prefixes, depths = _node_paths(tree)
        if tree.num_inner <= PER_NODE_MAX:
            parts = _node_bits(symbols, codes, lengths, prefixes, depths)
        else:
            parts = _level_bits(symbols, sigma, codes, lengths, prefixes,
                                depths)
        nodes = [RankBitVector(np.concatenate(p) if p
                               else np.zeros(0, np.uint8)) for p in parts]
        return cls(tree, len(symbols), nodes)

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(MAGIC)
            serial.write_u64(f, self.n)
            serial.write_u32(f, len(self.tree.symbols))
            for s in self.tree.symbols:
                serial.write_u32(f, int(s))
                serial.write_u8(f, self.tree.length[s])
                serial.write_u64(f, int(self.tree.hist.get(s, 0)))
            for bv in self.nodes:
                bv.write(f)


def _node_paths(tree: HuffmanTree):
    """(prefix, depth) per trie node id (root prefix=0 depth=0)."""
    prefixes = [0] * tree.num_inner
    depths = [0] * tree.num_inner
    stack = [(0, 0, 0)]
    while stack:
        nid, pref, d = stack.pop()
        prefixes[nid], depths[nid] = pref, d
        for bit in (0, 1):
            child = tree.children[nid][bit]
            if child is not None and child[0] == "node":
                stack.append((child[1], (pref << 1) | bit, d + 1))
    return np.array(prefixes), np.array(depths)


def _node_bits(symbols, codes, lengths, prefixes, depths):
    """Each node's bits by one pass over the text per node: per node,
    which symbols pass through it and the bit each takes there, two
    small tables, so the text is only gathered through them, in
    chunks."""
    in_sym, bit_sym = [], []
    for node_id in range(len(depths)):
        d = depths[node_id]
        below = lengths > d
        shift = np.where(below, lengths - d, 0)
        inside = below & ((codes >> shift) == prefixes[node_id])
        in_sym.append(inside)
        bit_sym.append(((codes >> np.maximum(shift - 1, 0)) & 1).astype(
            np.uint8))
    parts = [[] for _ in range(len(depths))]
    for a in range(0, len(symbols), BUILD_CHUNK):
        chunk = symbols[a:a + BUILD_CHUNK]
        for node_id in range(len(depths)):
            parts[node_id].append(
                bit_sym[node_id][chunk[in_sym[node_id][chunk]]])
    return parts


def _level_bits(symbols, sigma, codes, lengths, prefixes, depths):
    """Each node's bits by one pass over the text per level.  ``seq``
    holds the symbols whose code is longer than the depth d, grouped by
    their depth-d code prefix (one group per node, in prefix order) and
    in text order inside a group; a node's bits are its group's next code
    bits, and the next level's sequence is each group stably split by
    that bit, less the symbols whose code ends there.  Group sizes come
    from the symbol counts; the text moves in chunks, so a level holds
    two copies of the sequence and one chunk's scratch."""
    cnt = np.zeros(sigma, np.int64)
    for a in range(0, len(symbols), BUILD_CHUNK):
        c = np.bincount(symbols[a:a + BUILD_CHUNK], minlength=sigma)
        cnt += c[:sigma]
    parts = [[] for _ in range(len(depths))]
    seq = symbols
    for d in range(int(depths.max()) + 1):
        ids = np.flatnonzero(depths == d)
        ids = ids[np.argsort(prefixes[ids])]
        inner = lengths > d
        shift = np.where(inner, lengths - d - 1, 0)
        grp = np.searchsorted(prefixes[ids], codes >> (shift + 1))
        grp = np.where(inner, grp, 0)
        bit = ((codes >> shift) & 1).astype(np.uint8)
        keep = lengths > d + 1
        size = np.bincount(grp[inner], weights=cnt[inner],
                           minlength=len(ids)).astype(np.int64)
        end = np.cumsum(size)
        start = end - size
        kdt = np.uint16 if 2 * len(ids) <= 1 << 16 else np.int64
        child = (2 * grp + bit).astype(kdt)
        csize = np.bincount(child[keep], weights=cnt[keep],
                            minlength=2 * len(ids)).astype(np.int64)
        cstart = np.cumsum(csize) - csize
        placed = np.zeros(2 * len(ids), np.int64)
        nxt = np.empty(int(csize.sum()), seq.dtype)
        for a in range(0, len(seq), BUILD_CHUNK):
            chunk = seq[a:a + BUILD_CHUNK]
            b = bit[chunk]
            for k in range(int(np.searchsorted(end, a, "right")),
                           int(np.searchsorted(start, a + len(chunk)))):
                lo, hi = max(start[k], a) - a, min(end[k], a + len(chunk)) - a
                parts[ids[k]].append(b[lo:hi])
            kept = chunk[keep[chunk]]
            ch = child[kept]
            order = np.argsort(ch, kind="stable")
            ch_s = ch[order]
            rank = np.arange(len(ch_s)) - np.searchsorted(ch_s, ch_s)
            nxt[cstart[ch_s] + placed[ch_s] + rank] = kept[order]
            placed += np.bincount(ch, minlength=2 * len(ids))
            del b, kept, ch, order, ch_s, rank
        seq = nxt
    return parts
