"""Compressed suffix tree over the rotation-sorted order: LCP intervals.

Port of ``bwtb3m_tpu/index/cst.py`` (host numpy): the role of libmaus2's
``suffixtree::CompressedSuffixTree`` (included by upstream
src/probeScanDna.cpp:27; its hwt/rlhwt/words modes do not build it).  A
node is an interval [l, r] of the rank space plus its string depth, in
the LCP-interval representation (Abouelhoda et al., Fischer-Heun);
navigation needs only the LCP array, an RMQ over it (the ``.rmm`` file's
``RMMTree``, ``lcp/rmm.py``), and, for suffix links and child-by-letter,
the SA and the text.  All of them are files the suite writes already
(``.ulcp`` and ``.rmm`` from hwtToLCP, ``.sa`` at rate 1), so the tree is
a view over them, not an index format of its own.

The suffix order is over circular rotations (no terminator): leaves have
string depth n and LCP values are rotation LCPs; on pacterm inputs (one
unique terminator) this is the ordinary suffix tree of T$.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..lcp.rmm import RMMTree

Node = Tuple[int, int]          # inclusive rank interval [l, r]


class CompressedSuffixTree:
    def __init__(self, lcp: np.ndarray, sa: Optional[np.ndarray] = None,
                 text: Optional[np.ndarray] = None,
                 rmm: Optional[RMMTree] = None):
        self.lcp = np.asarray(lcp, dtype=np.int64)
        self.n = len(self.lcp)
        self.rmm = rmm if rmm is not None else RMMTree(self.lcp)
        self.sa = None if sa is None else np.asarray(sa, dtype=np.int64)
        self.text = None if text is None else np.asarray(text)
        self._isa = None

    @classmethod
    def from_files(cls, base: str, with_sa: bool = True
                   ) -> "CompressedSuffixTree":
        """Load from the suite's outputs: <base>.ulcp + <base>.rmm
        (+ <base>.sa at rate 1 for suffix links / child-by-letter)."""
        from ..io import formats
        from ..lcp.wavelet_lcp import read_ulcp

        lcp = read_ulcp(base + ".ulcp")
        try:
            rmm = RMMTree.read(base + ".rmm")
        except OSError:
            rmm = None
        sa = None
        if with_sa:
            try:
                rate, vals = formats.read_sampled_array(base + ".sa")
                if rate == 1:
                    sa = vals
            except OSError:
                pass
        return cls(lcp, sa=sa, rmm=rmm)

    # ------------------------------------------------------------ basics

    @property
    def root(self) -> Node:
        return (0, self.n - 1)

    def is_leaf(self, v: Node) -> bool:
        return v[0] == v[1]

    def count(self, v: Node) -> int:
        """Number of leaves (= rotations) below v."""
        return v[1] - v[0] + 1

    def _lcp_at(self, i: int) -> int:
        # LCP[n] sentinel: nothing extends past the last rank
        return int(self.lcp[i]) if 0 < i < self.n else -1

    def string_depth(self, v: Node) -> int:
        """Length of the node's path label (min pairwise LCP inside)."""
        l, r = v
        if l == r:
            return self.n          # a full rotation
        return self.rmm.rmq(l + 1, r + 1)[0]

    # -------------------------------------------------------- navigation

    def _extend(self, k: int, d: int) -> Node:
        """The unique LCP-interval of depth >= d containing rank k whose
        parent depth is < d: binary-search both boundaries with RMQ."""
        n = self.n
        # left boundary: smallest l with min lcp(l+1 .. k) >= d
        lo, hi = 0, k
        while lo < hi:
            mid = (lo + hi) // 2
            if self.rmm.rmq(mid + 1, k + 1)[0] >= d if mid < k else True:
                hi = mid
            else:
                lo = mid + 1
        l = lo
        # right boundary: largest r with min lcp(k+1 .. r) >= d
        lo, hi = k, n - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.rmm.rmq(k + 1, mid + 1)[0] >= d if mid > k else True:
                lo = mid
            else:
                hi = mid - 1
        return (l, lo)

    def parent(self, v: Node) -> Optional[Node]:
        l, r = v
        if (l, r) == self.root:
            return None
        # the shallower boundary wins (Abouelhoda up/down navigation)
        dl, dr = self._lcp_at(l), self._lcp_at(r + 1)
        d = max(dl, dr)
        k = l if dl >= dr else r + 1
        if d <= 0:
            return self.root
        return self._extend(k if k > 0 else 1, d)

    def children(self, v: Node) -> List[Node]:
        """Child intervals in rank order (split at the minima of LCP
        inside the interval — positions where LCP == string depth)."""
        l, r = v
        if l == r:
            return []
        d = self.string_depth(v)
        # split positions: i in (l, r] with LCP[i] == d
        splits = [l] + [int(i) for i in
                        np.flatnonzero(self.lcp[l + 1 : r + 1] == d) + l + 1]
        splits.append(r + 1)
        return [(splits[j], splits[j + 1] - 1)
                for j in range(len(splits) - 1)]

    def child(self, v: Node, c: int) -> Optional[Node]:
        """Child whose edge label starts with symbol c (needs sa + text)."""
        if self.sa is None or self.text is None:
            raise ValueError("child-by-letter needs sa and text")
        d = 0 if v == self.root else self.string_depth(v)
        for w in self.children(v):
            first = int(self.text[(self.sa[w[0]] + d) % self.n])
            if first == c:
                return w
        return None

    def suffix_link(self, v: Node) -> Optional[Node]:
        """sl(cw) = w: drop the first symbol of the path label
        (needs sa; the full ISA is derived once)."""
        if self.sa is None:
            raise ValueError("suffix_link needs the rate-1 sa")
        if v == self.root:
            return None
        d = self.string_depth(v)
        if d <= 1:
            return self.root
        if self._isa is None:
            self._isa = np.zeros(self.n, np.int64)
            self._isa[self.sa] = np.arange(self.n, dtype=np.int64)
        l2 = int(self._isa[(self.sa[v[0]] + 1) % self.n])
        r2 = int(self._isa[(self.sa[v[1]] + 1) % self.n])
        if l2 > r2:
            l2, r2 = r2, l2
        if l2 == r2:
            return (l2, r2)
        return self._extend_containing(l2, r2, d - 1)

    def _extend_containing(self, l2: int, r2: int, d: int) -> Node:
        k = self.rmm.rmq(l2 + 1, r2 + 1)[1]
        dd = int(self.lcp[k])
        return self._extend(k, min(dd, d))

    def lca(self, u: Node, v: Node) -> Node:
        """Lowest common ancestor of two nodes."""
        l = min(u[0], v[0])
        r = max(u[1], v[1])
        if l == r:
            return (l, r)
        k = self.rmm.rmq(l + 1, r + 1)[1]
        return self._extend(k, int(self.lcp[k]))

    # -------------------------------------------------------- matching

    def descend(self, pattern: np.ndarray) -> Optional[Node]:
        """Walk the tree along `pattern`; the resulting interval equals
        the FM backward-search interval of the same pattern (needs
        sa + text)."""
        v = self.root
        matched = 0
        p = np.asarray(pattern)
        while matched < len(p):
            w = self.child(v, int(p[matched]))
            if w is None:
                return None
            d = self.n if self.is_leaf(w) else self.string_depth(w)
            # verify the edge label beyond the branching symbol
            upto = min(d, len(p))
            for i in range(matched + 1, upto):
                if int(self.text[(self.sa[w[0]] + i) % self.n]) != int(p[i]):
                    return None
            matched = upto
            v = w
        return v
