"""Huffman-shaped wavelet trees: the ``.hwt`` and ``.rlhwt`` files.

Port of ``bwtb3m_tpu/index/wavelet.py`` (host numpy), the roles of
libmaus2's ``wavelet::ImpCompactHuffmanWaveletTree`` (built by upstream
src/bwttohwt.cpp:35-40) and ``ImpCompactRLHuffmanWaveletTree`` (upstream
src/hwtToRlHwt.cpp:89-198: one run-length bitvector per inner node).
``bwtb3m`` writes the ``.hwt`` with ``bwtonly=0``, ``bwttohwt`` and
``hwtToRlHwt`` write these files; the queries (access, rank,
inverse-select) serve ``hwtToRlHwt verify=1`` and the tests.  The FM
index answers its queries on the card over the rank rows
(``index/fm.py``), not over these trees.  Output is byte-identical to the
reference package's (tests/test_torch_pipeline.py,
tests/test_torch_index.py); the build codes the text in chunks,
scanning it once per node (few nodes) or once per level (many).  A
plain-node tree of at most ``PER_NODE_MAX`` inner nodes over a uint8
CUDA tensor is built on the card instead (``ops/hwt_bits.py``: one kernel
writes every node's words; the host keeps the header and the file).

File formats (FORMATS.md):

    HWT1 / RHW1:
      magic      4B    b"HWT1" (plain) or b"RHW1" (run-length nodes)
      n          u64
      nsyms      u32
      per symbol (sorted): sym u32, code length u8, count u64
      node blobs in node-id order (RankBitVector / RLBitVector serialization)

The canonical tree is rebuilt from the code lengths on load, so shape and
node numbering are deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from ..util import serial

from .bitvector import RankBitVector, RLBitVector
from .huffman import HuffmanTree

_MAGIC_PLAIN = b"HWT1"
_MAGIC_RL = b"RHW1"
BUILD_CHUNK = 1 << 24     # symbols coded at a time by ``build``
# up to this many inner nodes ``build`` scans the text once per node
# (``_node_bits``: DNA has 3); past it once per level (``_level_bits``:
# thousands of nodes, 10-20 levels)
PER_NODE_MAX = 16


class _WaveletBase:
    """Shared implementation; subclasses pick the node bitvector class."""

    BV: Type = RankBitVector
    MAGIC = _MAGIC_PLAIN
    route = "host"      # where ``build`` wrote the node words

    def __init__(self, tree: HuffmanTree, n: int, nodes):
        self.tree = tree
        self.n = n
        self.nodes = nodes  # list of bitvectors, index = trie node id
        counts = np.zeros(len(tree.symbols), dtype=np.int64)
        self.sym_list = np.array(tree.symbols, dtype=np.int64)
        for j, s in enumerate(tree.symbols):
            counts[j] = tree.hist.get(s, 0)
        # C array over the *present* symbols in sorted order
        self.counts = counts
        self.C = np.concatenate([[0], np.cumsum(counts)])

    @classmethod
    def build(cls, symbols, hist: Optional[Dict[int, int]] = None):
        """The tree of ``symbols`` (``hist``: their counts, when the caller
        has them).  A CUDA tensor takes the card route (``route`` =
        "device"): it must be uint8, come with ``hist``, and make a tree
        of plain bitvectors with at most ``PER_NODE_MAX`` inner nodes;
        any other CUDA tensor raises, so none is downloaded.  Every other
        input takes the host route."""
        on_card = torch.is_tensor(symbols) and symbols.is_cuda
        if on_card and (cls.BV is not RankBitVector or hist is None
                        or symbols.dtype != torch.uint8):
            raise ValueError("the card route takes a uint8 CUDA tensor "
                             "with its histogram, into plain nodes")
        if not on_card:
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
            inside, bit = _node_tables(codes, lengths, prefixes, depths)
            if on_card:
                wt = cls(tree, len(symbols),
                         _card_nodes(symbols, inside, bit))
                wt.route = "device"
                return wt
            parts = _node_bits(symbols, inside, bit)
        else:
            if on_card:
                raise ValueError("the card route takes at most %d inner "
                                 "nodes, this tree has %d"
                                 % (PER_NODE_MAX, tree.num_inner))
            parts = _level_bits(symbols, sigma, codes, lengths, prefixes,
                                depths)
        nodes = [cls.BV(np.concatenate(p) if p
                        else np.zeros(0, np.uint8)) for p in parts]
        return cls(tree, len(symbols), nodes)

    # ---- queries --------------------------------------------------------
    def access(self, i) -> np.ndarray:
        """Symbol(s) at position(s) i (batch)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        out = np.zeros(len(i), dtype=np.int64)
        node = np.zeros(len(i), dtype=np.int64)  # trie node id
        pos = i.copy()
        settled = np.zeros(len(i), dtype=bool)
        for _d in range(self.tree.max_length):
            for nid in np.unique(node[~settled]):
                sel = (~settled) & (node == nid)
                bv = self.nodes[nid]
                bits = bv.get(pos[sel])
                r1 = bv.rank1(pos[sel])
                newpos = np.where(bits == 1, r1, pos[sel] - r1)
                child0, child1 = self.tree.children[nid]
                for bit_val, child in ((0, child0), (1, child1)):
                    bsel = bits == bit_val
                    if not bsel.any() or child is None:
                        continue
                    idx = np.flatnonzero(sel)[bsel]
                    if child[0] == "leaf":
                        out[idx] = child[1]
                        settled[idx] = True
                    else:
                        node[idx] = child[1]
                        pos[idx] = newpos[bsel]
            if settled.all():
                break
        return out

    def rank(self, c: int, i) -> np.ndarray:
        """rank of symbol c at position(s) i (batch over i)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        if c not in self.tree.code:
            return np.zeros(len(i), dtype=np.int64)
        code, length = self.tree.code[c], self.tree.length[c]
        pos = i.copy()
        node = 0
        for d in range(length):
            bit = (code >> (length - 1 - d)) & 1
            bv = self.nodes[node]
            pos = bv.rank1(pos) if bit else bv.rank0(pos)
            child = self.tree.children[node][bit]
            if child is None:
                return np.zeros(len(i), dtype=np.int64)
            if child[0] == "leaf":
                break
            node = child[1]
        return pos

    def inverse_select(self, i) -> Tuple[np.ndarray, np.ndarray]:
        """(symbol, rank-of-symbol-at-i) pairs — the ``extendedLF`` primitive
        (upstream src/checkbwt.cpp:202 uses sym + new rank)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        syms = np.zeros(len(i), dtype=np.int64)
        pos = i.copy()
        node = np.zeros(len(i), dtype=np.int64)
        settled = np.zeros(len(i), dtype=bool)
        for _d in range(self.tree.max_length):
            for nid in np.unique(node[~settled]):
                sel = (~settled) & (node == nid)
                bv = self.nodes[nid]
                bits = bv.get(pos[sel])
                r1 = bv.rank1(pos[sel])
                newpos = np.where(bits == 1, r1, pos[sel] - r1)
                child0, child1 = self.tree.children[nid]
                for bit_val, child in ((0, child0), (1, child1)):
                    bsel = bits == bit_val
                    if not bsel.any() or child is None:
                        continue
                    idx = np.flatnonzero(sel)[bsel]
                    if child[0] == "leaf":
                        syms[idx] = child[1]
                        pos[idx] = newpos[bsel]
                        settled[idx] = True
                    else:
                        node[idx] = child[1]
                        pos[idx] = newpos[bsel]
            if settled.all():
                break
        return syms, pos

    def decode_all(self) -> np.ndarray:
        return self.access(np.arange(self.n))

    # ---- serialization --------------------------------------------------
    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            serial.write_u64(f, self.n)
            serial.write_u32(f, len(self.tree.symbols))
            for s in self.tree.symbols:
                serial.write_u32(f, int(s))
                serial.write_u8(f, self.tree.length[s])
                serial.write_u64(f, int(self.tree.hist.get(s, 0)))
            for bv in self.nodes:
                bv.write(f)

    @classmethod
    def read(cls, path: str):
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != cls.MAGIC:
                raise ValueError(
                    "bad wavelet magic %r in %s (expected %r)"
                    % (magic, path, cls.MAGIC)
                )
            n = serial.read_u64(f)
            nsyms = serial.read_u32(f)
            lengths = {}
            hist = {}
            for _ in range(nsyms):
                s = serial.read_u32(f)
                lengths[s] = serial.read_u8(f)
                hist[s] = serial.read_u64(f)
            tree = HuffmanTree.from_lengths(lengths)
            tree.hist = hist
            nodes = [cls.BV.read(f) for _ in range(tree.num_inner)]
        return cls(tree, n, nodes)


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


def _node_tables(codes, lengths, prefixes, depths):
    """(inside, bit), bool and uint8 [nodes, sigma]: per node, which
    symbols pass through it and the bit each takes there."""
    nodes, sigma = len(depths), len(codes)
    inside = np.zeros((nodes, sigma), bool)
    bit = np.zeros((nodes, sigma), np.uint8)
    for node_id in range(nodes):
        d = depths[node_id]
        below = lengths > d
        shift = np.where(below, lengths - d, 0)
        inside[node_id] = below & ((codes >> shift) == prefixes[node_id])
        bit[node_id] = (codes >> np.maximum(shift - 1, 0)) & 1
    return inside, bit


def _node_bits(symbols, inside, bit):
    """Each node's bits by one pass over the text per node: the text is
    gathered through the node's two tables (``_node_tables``), in
    chunks."""
    parts = [[] for _ in range(len(inside))]
    for a in range(0, len(symbols), BUILD_CHUNK):
        chunk = symbols[a:a + BUILD_CHUNK]
        for node_id in range(len(inside)):
            parts[node_id].append(bit[node_id][chunk[inside[node_id][chunk]]])
    return parts


def _card_nodes(symbols, inside, bit):
    """The nodes of a uint8 CUDA text from the node-word kernel, the words
    downloaded once and taken as they are."""
    from ..ops.hwt_bits import hwt_node_words
    pad = ((0, 0), (0, 256 - inside.shape[1]))
    words, lens = hwt_node_words(symbols,
                                 torch.from_numpy(np.pad(inside, pad)),
                                 torch.from_numpy(np.pad(bit, pad)))
    words = words.cpu().numpy().view(np.uint64)
    nodes, at = [], 0
    for m in lens:
        nw = (m + 63) // 64
        nodes.append(RankBitVector.from_words(m, words[at:at + nw]))
        at += nw
    return nodes


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


class HuffmanWaveletTree(_WaveletBase):
    """Plain-bitvector Huffman wavelet tree (.hwt)."""

    BV = RankBitVector
    MAGIC = _MAGIC_PLAIN


class RLHuffmanWaveletTree(_WaveletBase):
    """Run-length-node Huffman wavelet tree (.rlhwt)."""

    BV = RLBitVector
    MAGIC = _MAGIC_RL
