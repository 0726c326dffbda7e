"""Every symbol's rank at a batch of positions, over any rank rows.

Port of ``bwtb3m_tpu/ops/rank.py::rank_all_symbols_batch``, which
computes ``out[j, c] = rank(c, i[j])`` for all sigma symbols over the
reference's ``OccTable`` (int32 counts of every symbol per 128-symbol
block plus the block's symbols).  The rest of that module is
``ops/wavelet_rows.py`` (``build_occ``, ``rank_batch``, ``access_batch``,
``occ_total_counts``) and ``ops/focc*.py``.  Here the function takes
whichever rows the port built, and runs as torch on their device (no
hand kernel: one row gather per position and level, then vector
arithmetic):

- wavelet rows (sigma > 256): ``wavelet_rows.rank_all``, a level walk
  that reads about sigma / 7 64-byte blocks a position;
- sector and bit-plane rows: ``focc_bp.rank_all_batch_bp``, one row a
  position (its checkpoint words carry every count);
- byte rows: one row a position, its sigma checkpoint counts plus a
  count of each symbol among the block's first ``off`` bytes;
- wide rows: the narrow rows' ranks plus each symbol's wraps past 2^32.

Like the reference function it has no caller in either package; the FM
index reaches one symbol's rank at a time (``ops/lf.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import focc, wavelet_rows as wr
from .focc_bp import FusedOccBP, rank_all_batch_bp
from .wideocc import WideOcc


def _rank_all_bytes(rows: focc.FusedOcc, i: torch.Tensor) -> torch.Tensor:
    """[B, sigma] int64 over byte rows: the checkpoint counts of the
    position's row plus the symbols of its block before the position."""
    r = rows.rows[i >> 8]
    off = i & (focc.BLOCK - 1)
    sigma = rows.sigma
    occ = r[:, focc.BLOCK:focc.BLOCK + 4 * sigma].contiguous().view(
        torch.int32).long() & 0xFFFFFFFF
    before = (torch.arange(focc.BLOCK, device=i.device)[None, :]
              < off[:, None]).long()
    inblk = torch.zeros((len(i), 256), dtype=torch.int64, device=i.device)
    inblk.scatter_add_(1, r[:, :focc.BLOCK].long(), before)
    return occ + inblk[:, :sigma]


def _rank_all_dense(rows, i: torch.Tensor) -> torch.Tensor:
    if isinstance(rows, wr.WaveletRows):
        return wr.rank_all(rows, i)
    if isinstance(rows, WideOcc):
        hi = (rows.thr[None, :, :] <= (i >> rows.SHIFT)[:, None, None]).sum(2)
        return _rank_all_dense(rows.focc, i) + (hi << 32)
    if isinstance(rows, FusedOccBP):
        return rank_all_batch_bp(rows, i)
    if isinstance(rows, focc.FusedOcc):
        return _rank_all_bytes(rows, i)
    raise ValueError("rank_all_symbols_batch takes wavelet, sector, "
                     "bit-plane, byte or wide rank rows, not %s"
                     % type(rows).__name__)


def rank_all_symbols_batch(rows, i: torch.Tensor,
                           symmap: Optional[np.ndarray] = None,
                           sigma: Optional[int] = None) -> torch.Tensor:
    """``out[j, c]``: the occurrences of symbol c in bwt[0 : i[j]) for
    every symbol, int64 ``[B, sigma]``, positions in [0, n], on the rows'
    device.  ``rows`` are over dense ids; where they were compacted
    (``BwtResult.load_wavelet`` / ``load_focc`` with ``dense=True``),
    ``symmap`` (dense id -> file symbol) puts each column back at its
    file symbol in a ``[B, sigma]`` result (``sigma``: the file's
    alphabet, by default ``symmap[-1] + 1``), absent symbols 0, the
    reference's column order.  The caller budgets B x sigma x 8 bytes of
    result."""
    i = i.to(rows.C.device).long()
    dense = _rank_all_dense(rows, i)
    if symmap is None:
        return dense
    sm = torch.as_tensor(np.asarray(symmap, np.int64), device=dense.device)
    width = int(sigma) if sigma is not None else int(sm[-1]) + 1
    out = torch.zeros((dense.shape[0], width), dtype=torch.int64,
                      device=dense.device)
    out[:, sm] = dense
    return out
