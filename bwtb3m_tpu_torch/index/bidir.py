"""True bidirectional FM index: synchronized forward/reverse intervals.

Port of ``bwtb3m_tpu/index/bidir.py``, the role of libmaus2's
``BidirectionalDnaIndexImpCompactHuffmanWaveletTree`` (upstream
src/allHamDna.cpp:59): one index over the text and one over its reverse,
kept in lockstep so that a match window extends by a symbol on either
side in O(1) rank work (Lam et al. 2009 2BWT, Li 2012 FMD).

State per pattern window w: (lo, lo_rev, size) with [lo, lo+size) the
rotations of T prefixed by w (rank space of BWT(T)) and [lo_rev,
lo_rev+size) the rotations of reverse(T) prefixed by reverse(w).

extend_left(a):  w -> a.w   via the FORWARD index:
    lo'     = C[a] + occ_a(lo)
    size'   = occ_a(lo+size) - occ_a(lo)
    lo_rev' = lo_rev + sum_{b < a} (occ_b(lo+size) - occ_b(lo))
extend_right(a): w -> w.a   symmetric through the reverse index.

The smaller-symbol sums come from ``ops/focc_bp.py::rank_all_batch_bp``,
all sigma ranks from one gathered row, so an extension is two row
gathers per batch.  Every operation takes [B] int64 interval tensors on
the index's device (the card unless ``device="cpu"``): batched torch,
one call for thousands of windows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.focc import from_u32_bits
from ..ops.focc_bp import FusedOccBP, rank_all_batch_bp
from ..ops.focc_build import build_focc_host, focc_from_jax
from ..util.devices import resolve_device


class BidirectionalFMIndex:
    def __init__(self, bwt_fwd: np.ndarray, bwt_rev: np.ndarray,
                 sigma: int, device="cuda"):
        if sigma > 8:
            raise ValueError("bidirectional index uses the bit-plane "
                             "rank rows (sigma <= 8)")
        self.device = resolve_device(device)
        self.sigma = int(sigma)
        self.n = len(bwt_fwd)
        assert len(bwt_rev) == self.n
        self.fwd, self.rev = (
            build_focc_host(np.asarray(b, np.uint8), self.sigma, self.device,
                            "bitplane") for b in (bwt_fwd, bwt_rev))

    @classmethod
    def from_text(cls, text: np.ndarray, sigma: int, device="cuda"
                  ) -> "BidirectionalFMIndex":
        """Both BWTs by the port's prefix-doubling sort
        (``ops/doubling.py``) on ``device``."""
        from ..ops.doubling import suffix_array

        device = resolve_device(device)
        text = np.asarray(text, dtype=np.int32)
        _sa, _isa, bwt_f = suffix_array(text, sigma, device)
        _sa2, _isa2, bwt_r = suffix_array(text[::-1].copy(), sigma, device)
        return cls(np.asarray(bwt_f, np.uint8), np.asarray(bwt_r, np.uint8),
                   sigma, device)

    # ------------------------------------------------------------- state

    def whole(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """[B] interval state covering the whole rank space (empty w)."""
        z = torch.zeros(batch, dtype=torch.int64, device=self.device)
        return z, z.clone(), torch.full_like(z, self.n)

    # -------------------------------------------------------- extensions

    def _extend(self, focc: FusedOccBP, a, lo, lo_o, size):
        """Shared extension arithmetic through `focc` (fwd for
        extend_left, rev for extend_right)."""
        a = torch.as_tensor(a, device=self.device).long().reshape(-1, 1)
        lo, lo_o, size = (torch.as_tensor(t, device=self.device).long()
                          for t in (lo, lo_o, size))
        ranks_l = rank_all_batch_bp(focc, lo)                 # [B, sigma]
        win = rank_all_batch_bp(focc, lo + size) - ranks_l
        cols = torch.arange(self.sigma, device=self.device)[None, :]
        smaller = torch.where(cols < a, win, 0).sum(1)
        C = from_u32_bits(focc.C)
        return (C[a[:, 0]] + ranks_l.gather(1, a)[:, 0], lo_o + smaller,
                win.gather(1, a)[:, 0])

    def extend_left(self, a, lo, lo_rev, size):
        """w -> a.w; returns (lo', lo_rev', size') (size' 0 = no match)."""
        return self._extend(self.fwd, a, lo, lo_rev, size)

    def extend_right(self, a, lo, lo_rev, size):
        """w -> w.a: extend reverse(w) on its left through the reverse
        index; the roles of the two interval words swap."""
        lo_rev2, lo2, cnt = self._extend(self.rev, a, lo_rev, lo, size)
        return lo2, lo_rev2, cnt

    # ----------------------------------------------------------- queries

    def count(self, pattern: np.ndarray, from_right: bool = False) -> int:
        """Occurrences of `pattern` as a rotation prefix window,
        extending symbol-by-symbol from the chosen side."""
        p = np.asarray(pattern, dtype=np.int64)
        lo, lo_rev, size = self.whole(1)
        ext = self.extend_right if from_right else self.extend_left
        for c in (p if from_right else p[::-1]):
            lo, lo_rev, size = ext([int(c)], lo, lo_rev, size)
        return int(size[0])

    def interval(self, pattern: np.ndarray) -> Tuple[int, int, int]:
        """(lo, lo_rev, size) of the pattern window (left extension)."""
        p = np.asarray(pattern, dtype=np.int64)
        lo, lo_rev, size = self.whole(1)
        for c in p[::-1]:
            lo, lo_rev, size = self.extend_left([int(c)], lo, lo_rev, size)
        return int(lo[0]), int(lo_rev[0]), int(size[0])


def bidir_from_jax(jax_bidir, device="cuda") -> BidirectionalFMIndex:
    """The port's index over a reference ``BidirectionalFMIndex``'s own
    rank rows (``focc_from_jax``: its bit-plane rows byte for byte)."""
    obj = BidirectionalFMIndex.__new__(BidirectionalFMIndex)
    obj.device = resolve_device(device)
    obj.sigma = int(jax_bidir.sigma)
    obj.n = int(jax_bidir.n)
    obj.fwd = focc_from_jax(jax_bidir.fwd, obj.device, "bitplane")
    obj.rev = focc_from_jax(jax_bidir.rev, obj.device, "bitplane")
    return obj
