"""Batched backward-search steps over any of the port's rank rows.

Port of ``bwtb3m_tpu/ops/lf.py::backward_search_step`` (the reference's
``LF.step(sym, lo, hi)``, upstream src/probeScanDna.cpp:100-107): for a
batch of patterns, the interval of rotations prefixed by c . pattern from
that of the pattern,

    (lo, hi) -> (C[c] + rank(c, lo), C[c] + rank(c, hi)),

as torch over the plain ``rank`` of each row family: the sector, bit-plane
and byte rows (``ops/focc.py``), the wide rows (``ops/wideocc.py``) and
the wavelet rows (``ops/wavelet_rows.py``).  Each call is two batched row
gathers, no loop over lanes, so it runs on the rows' device as they are;
the FM index (``index/fm.py``), ``probeScanDna`` and ``allHamDna`` step
every k-mer or search state of a batch through one call per symbol.
Symbols are the rows' dense ids; intervals are int64 tensors.

``hamming_search_plain`` is the plain version of ``allHamDna``'s
breadth-first search on the card (``apps/hamdna.py``): the reference's
depth-first recursion itself, over these steps.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import focc, wavelet_rows as wr
from .focc import from_u32_bits
from .wideocc import WideOcc, rank_w


def c_values(rows) -> torch.Tensor:
    """The C array of any rank rows as int64 [sigma + 1] (the narrow rows
    keep it as uint32 bits, exact below 2^32 symbols)."""
    if isinstance(rows, (WideOcc, wr.WaveletRows)):
        return rows.C
    return from_u32_bits(rows.C)


def rank(rows, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of the dense symbol c[j] in bwt[0 : i[j]), int64, over
    any of the port's rank rows."""
    c, i = c.long(), i.long()
    if isinstance(rows, wr.WaveletRows):
        return wr.rank(rows, c, i)
    if isinstance(rows, WideOcc):
        return rank_w(rows, c, i)
    return focc.rank(rows, c, i)


def backward_search_step(rows, c: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, C: torch.Tensor = None):
    """One backward-search step of every lane: the half-open interval
    (lo, hi) of rotations prefixed by a pattern becomes that of c .
    pattern.  ``C``: the rows' ``c_values``, where the caller keeps it."""
    c = c.long()
    base = (c_values(rows) if C is None else C)[c]
    return base + rank(rows, c, lo), base + rank(rows, c, hi)


def hamming_search_plain(rows, ids, patterns: Sequence[np.ndarray],
                         maxmis: int) -> List[List[Tuple[int, int, int]]]:
    """The reference's depth-first Hamming recursion
    (``hammingSearchRecUnmapped``) for every pattern of 2-bit codes, each
    with its own stack (children pushed in reverse base order, so base
    0's subtree is explored first; a child with an empty interval, where
    the recursion returns at once, is not pushed), one node of every
    pattern expanded per batched ``backward_search_step``.  ``ids``: the
    rows' dense ids of the four bases (-1 where absent).  Returns each
    pattern's (lo, hi, nm) list in the recursion's order."""
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
    C = c_values(rows)
    dev = C.device
    stacks = [[(len(q) - 1, 0, rows.n, 0)] for q in patterns]
    out: List[List[Tuple[int, int, int]]] = [[] for _ in patterns]
    while True:
        kids = []                      # (pattern, j, nm2, lo, hi, dense)
        for i, st in enumerate(stacks):
            if not st:
                continue
            j, lo, hi, nm = st.pop()
            if hi <= lo:
                continue
            if j < 0:
                out[i].append((lo, hi, nm))
                continue
            want = int(patterns[i][j])
            for c in range(4):
                nm2 = nm + (1 if c != want else 0)
                if nm2 <= maxmis:
                    kids.append((i, j - 1, nm2, lo, hi, int(ids[c])))
        if not kids:
            if not any(stacks):
                return out
            continue
        k = torch.from_numpy(np.array(kids, dtype=np.int64)).to(dev)
        d = k[:, 5]
        l2, h2 = backward_search_step(rows, d.clamp(min=0), k[:, 3],
                                      k[:, 4], C)
        l2 = torch.where(d >= 0, l2, 0).cpu().numpy()
        h2 = torch.where(d >= 0, h2, 0).cpu().numpy()
        for row in reversed(range(len(kids))):
            if h2[row] > l2[row]:     # the recursion returns at once else
                i, j, nm2 = kids[row][:3]
                stacks[i].append((j, int(l2[row]), int(h2[row]), nm2))
