"""Canonical Huffman trees, the shape of the ``.hwt`` wavelet tree.

Carried over from ``bwtb3m_tpu/index/huffman.py`` (host numpy): the
``.hwt`` writer builds it from a histogram, the RLH1 reader
(``io/rlh.py``) rebuilds it from code lengths (``from_lengths``).
Deterministic construction: ties in the priority queue are broken
by (weight, order-of-creation), and the final code is canonicalized
(sorted by (length, symbol)) so a tree rebuilt from the same histogram is
always identical.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np


class HuffmanTree:
    """Canonical Huffman code over an integer alphabet."""

    def __init__(self, hist: Dict[int, int]):
        if not hist:
            raise ValueError("empty histogram")
        self.hist = {int(s): int(c) for s, c in hist.items() if c > 0}
        syms = sorted(self.hist)
        if len(syms) == 1:
            lengths = {syms[0]: 1}
        else:
            heap: List[Tuple[int, int, object]] = []
            counter = 0
            for s in syms:
                heap.append((self.hist[s], counter, s))
                counter += 1
            heapq.heapify(heap)
            parent: Dict[object, object] = {}
            while len(heap) > 1:
                w1, _, n1 = heapq.heappop(heap)
                w2, _, n2 = heapq.heappop(heap)
                node = ("i", counter)
                parent[n1 if isinstance(n1, tuple) else ("l", n1)] = node
                parent[n2 if isinstance(n2, tuple) else ("l", n2)] = node
                heapq.heappush(heap, (w1 + w2, counter, node))
                counter += 1
            lengths = {}
            for s in syms:
                d = 0
                node = ("l", s)
                while node in parent:
                    node = parent[node]
                    d += 1
                lengths[s] = d
        # canonical codes: sort by (length, symbol)
        order = sorted(syms, key=lambda s: (lengths[s], s))
        self.code: Dict[int, int] = {}
        self.length: Dict[int, int] = {}
        code = 0
        prev_len = 0
        for s in order:
            l = lengths[s]
            code <<= (l - prev_len)
            self.code[s] = code
            self.length[s] = l
            code += 1
            prev_len = l
        self.symbols = syms
        self.max_length = max(lengths.values())
        self._build_nodes()

    def _build_nodes(self) -> None:
        """Explicit tree: node 0 = root; inner nodes only.

        node -> (left_child, right_child); child is ('leaf', sym) or
        ('node', id). Built by inserting canonical codes into a trie.
        """
        self.children: List[List[object]] = [[None, None]]
        for s in self.symbols:
            code, l = self.code[s], self.length[s]
            node = 0
            for d in range(l):
                bit = (code >> (l - 1 - d)) & 1
                if d == l - 1:
                    self.children[node][bit] = ("leaf", s)
                else:
                    nxt = self.children[node][bit]
                    if nxt is None:
                        self.children.append([None, None])
                        nxt = ("node", len(self.children) - 1)
                        self.children[node][bit] = nxt
                    node = nxt[1]
        self.num_inner = len(self.children)

    def encode_lengths(self) -> Dict[int, int]:
        return dict(self.length)

    def decode_path(self, sym: int) -> Tuple[int, int]:
        """(code, length) for a symbol."""
        return self.code[sym], self.length[sym]

    @classmethod
    def from_lengths(cls, lengths: Dict[int, int]) -> "HuffmanTree":
        """Rebuild the canonical tree from code lengths only."""
        obj = cls.__new__(cls)
        obj.hist = {s: 1 for s in lengths}
        obj.symbols = sorted(lengths)
        obj.length = {int(s): int(l) for s, l in lengths.items()}
        order = sorted(obj.symbols, key=lambda s: (obj.length[s], s))
        obj.code = {}
        code = 0
        prev_len = 0
        for s in order:
            l = obj.length[s]
            code <<= (l - prev_len)
            obj.code[s] = code
            code += 1
            prev_len = l
        obj.max_length = max(obj.length.values())
        obj._build_nodes()
        return obj

    def code_arrays(self, sigma: int) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, lengths) dense arrays up to sigma (0 length = absent)."""
        codes = np.zeros(sigma, dtype=np.int64)
        lengths = np.zeros(sigma, dtype=np.int64)
        for s in self.symbols:
            codes[s] = self.code[s]
            lengths[s] = self.length[s]
        return codes, lengths
