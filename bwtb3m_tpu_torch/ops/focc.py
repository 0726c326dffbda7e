"""Byte rank rows (8 < sigma <= 256) and the layout-dispatching queries.

Port of ``bwtb3m_tpu/ops/focc.py``.  One row per 256-symbol block:

    row[b] = [ 256 BWT symbols (uint8) | occ counts as 4 little-endian
               bytes per symbol | zero pad to a multiple of 128 ]

plus the C array.  Rows are ``uint8 [nb+1, roww]``; row nb carries the
totals.  ``lf_step`` / ``rank`` / ``access`` here take any layout and
dispatch to ``ops/focc_bp.py`` for bit-plane and sector rows, as the
reference's ``*_batch_f`` queries do.  These are the plain PyTorch
versions the walk kernels are held against: each computes on the very
rows its kernel reads.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from . import focc_bp
from .focc_bp import FusedOccBP

BLOCK = 256
_U32 = 0xFFFFFFFF


def _row_width(sigma: int, block: int) -> int:
    w = block + 4 * sigma
    return ((w + 127) // 128) * 128


@dataclasses.dataclass
class FusedOcc:
    """Byte rank rows (blocks of 256 symbols) + C array."""

    rows: torch.Tensor        # uint8 [nb+1, roww]
    C: torch.Tensor           # int32 [sigma+1]
    n: int
    sigma: int

    LAYOUT: ClassVar[str] = "bytes"
    SHIFT: ClassVar[int] = 8          # log2 of the block's symbols
    MAX_SIGMA: ClassVar[int] = 256

    @classmethod
    def num_rows(cls, n: int) -> int:
        return max(1, (n + BLOCK - 1) // BLOCK) + 1


def as_u32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 values, taken modulo 2^32, as the int32 of the same bits:
    uint32 words (the rows' occ words, C, narrow ranks) travel so, as
    torch has no uint32 arithmetic."""
    t = t & _U32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def from_u32_bits(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 values in [0, 2^32)."""
    return t.long() & _U32


def kernel_row_width(focc) -> int:
    """The row width by which the walk kernels select the layout (32
    sector, 128 bit-plane, >= 384 bytes), after checking that the rows
    are what the kernels read: contiguous uint8 of the layout's width,
    aligned to the loads (32 bytes for a sector row, 16 otherwise)."""
    rows = focc.rows
    if rows.dtype != torch.uint8 or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise TypeError("rank rows must be a contiguous uint8 matrix")
    roww = rows.shape[1]
    if isinstance(focc, FusedOccBP):
        ok = roww == focc.ROW_BYTES
    else:
        ok = roww >= 384 and roww % 128 == 0
    if not ok or focc.sigma > focc.MAX_SIGMA \
            or rows.shape[0] < focc.num_rows(focc.n):
        raise ValueError("rank rows [%d, %d] do not match the %s layout "
                         "(n=%d, sigma=%d)" % (*rows.shape, focc.LAYOUT,
                                               focc.n, focc.sigma))
    align = 32 if roww == 32 else 16
    if rows.data_ptr() % align:
        raise ValueError("%s rank rows must be %d-byte aligned"
                         % (focc.LAYOUT, align))
    return roww


def _rows(focc: FusedOcc, i: torch.Tensor):
    return focc.rows[i >> 8], i & (BLOCK - 1)


def _symbol(rows: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return rows.gather(1, off[:, None]).squeeze(1).long()


def _occ(rows: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    k = torch.arange(4, device=c.device)
    b = rows.gather(1, BLOCK + 4 * c[:, None] + k).long()
    return (b << (8 * k)).sum(1)


def _inblock(rows: torch.Tensor, c: torch.Tensor,
             off: torch.Tensor) -> torch.Tensor:
    col = torch.arange(BLOCK, device=c.device)
    hit = (rows[:, :BLOCK].long() == c[:, None]) & (col < off[:, None])
    return hit.sum(1)


def access(focc, i: torch.Tensor) -> torch.Tensor:
    """bwt[i] (int64) for a batch of int64 positions."""
    if isinstance(focc, FusedOccBP):
        return focc_bp.access(focc, i)
    rows, off = _rows(focc, i)
    return _symbol(rows, off)


def rank(focc, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[j] in bwt[0:i[j])."""
    if isinstance(focc, FusedOccBP):
        return focc_bp.rank(focc, c, i)
    rows, off = _rows(focc, i)
    return _occ(rows, c) + _inblock(rows, c, off)


def lf_step(focc, r: torch.Tensor):
    """Extended LF for a batch of ranks: (sym, r') with
    r' = C[sym] + rank(sym, r), from one row per lane."""
    if isinstance(focc, FusedOccBP):
        return focc_bp.lf_step(focc, r)
    rows, off = _rows(focc, r)
    sym = _symbol(rows, off)
    return sym, (from_u32_bits(focc.C)[sym] + _occ(rows, sym)
                 + _inblock(rows, sym, off))
