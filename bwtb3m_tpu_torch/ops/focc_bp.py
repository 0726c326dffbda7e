"""Bit-plane fused rank rows (sigma <= 8) and their plain queries.

Port of ``bwtb3m_tpu/ops/focc_bp.py``, in two layouts.  Both store, per
block of symbols, the block's bit planes (LSB first, as little-endian
uint32 words) followed by the occ checkpoints (symbol counts before the
block), plus the C array:

``FusedOccBP``, the reference's layout byte for byte: one 128-byte row
per 256-symbol block,

    words  0..7     bit-plane 0 of the block's 256 symbols
    words  8..15    bit-plane 1
    words 16..23    bit-plane 2
    words 24..24+sigma-1   occ checkpoints
    remaining words        zero

in ``uint8 [nb+1, 128]`` with nb = max(1, ceil(n / 256)) (row nb carries
the totals, so a query at i == n reads a real row).  The reference
stored int8 rows; uint8 keeps symbol bytes >= 128 from sign-extending.

``FusedOccSector`` (sigma <= 4), the layout of the H100's 32-byte memory
sector: one 32-byte row per 64-symbol block,

    words 0..1      bit-plane 0 of the block's 64 symbols
    words 2..3      bit-plane 1
    words 4..7      occ checkpoints of symbols 0..3 (zero from sigma on)

in ``uint8 [n // 64 + 1, 32]``: the same 0.5 bytes per symbol, and the
row of i == n exists.  A query reads one sector where the 128-byte row
costs four; the walk kernels (``csrc/focc_rows.cuh``) are bound by that.

Pad positions past n hold symbol 0 in the planes and are never counted.
The queries below are the plain PyTorch versions, one code for both
layouts: the tests hold them against the reference, and the walk kernels
(``ops/lf_walk.py``, ``ops/gapbatch.py``) against them.  Positions and
ranks are int64 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class FusedOccBP:
    """Bit-plane rank rows (blocks of 256 symbols, 128 bytes) + C array."""

    rows: torch.Tensor        # uint8 [nb+1, 128]
    C: torch.Tensor           # int32 [sigma+1]
    n: int
    sigma: int

    LAYOUT: ClassVar[str] = "bitplane"
    SHIFT: ClassVar[int] = 8          # log2 of the block's symbols
    NPLANES: ClassVar[int] = 3
    ROW_BYTES: ClassVar[int] = 128
    MAX_SIGMA: ClassVar[int] = 8

    @classmethod
    def plane_words(cls) -> int:
        return (1 << cls.SHIFT) // 32

    @classmethod
    def occ_word(cls) -> int:
        """Index of the first occ checkpoint word."""
        return cls.NPLANES * cls.plane_words()

    @classmethod
    def num_rows(cls, n: int) -> int:
        return max(1, (n + 255) // 256) + 1


@dataclasses.dataclass
class FusedOccSector(FusedOccBP):
    """Sector rank rows (blocks of 64 symbols, 32 bytes) + C array."""

    LAYOUT: ClassVar[str] = "sector"
    SHIFT: ClassVar[int] = 6
    NPLANES: ClassVar[int] = 2
    ROW_BYTES: ClassVar[int] = 32
    MAX_SIGMA: ClassVar[int] = 4

    @classmethod
    def num_rows(cls, n: int) -> int:
        return n // 64 + 1


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int64 tensors holding uint32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _words(focc: FusedOccBP, i: torch.Tensor):
    """One row per lane as uint32 words in int64, and the offset inside
    the block: ([B, ROW_BYTES / 4], off in [0, block))."""
    rows = focc.rows[i >> focc.SHIFT]
    return (rows.view(torch.int32).long() & _U32,
            i & ((1 << focc.SHIFT) - 1))


def _planes(focc: FusedOccBP, words: torch.Tensor) -> torch.Tensor:
    return words[:, :focc.occ_word()].reshape(-1, focc.NPLANES,
                                              focc.plane_words())


def _symbol(focc: FusedOccBP, words: torch.Tensor,
            off: torch.Tensor) -> torch.Tensor:
    w = (off >> 5).view(-1, 1, 1).expand(-1, focc.NPLANES, 1)
    pw = _planes(focc, words).gather(2, w).squeeze(2)       # [B, NPLANES]
    bits = (pw >> (off & 31)[:, None]) & 1
    return (bits << torch.arange(focc.NPLANES, device=off.device)).sum(1)


def prefix_mask(off: torch.Tensor, nwords: int) -> torch.Tensor:
    """[B, nwords] uint32 words (in int64) masking bit positions < off.
    keep == 0 and keep == 32 are selected explicitly, as in the kernel,
    where a shift by 32 is undefined."""
    base = 32 * torch.arange(nwords, device=off.device)
    keep = (off[:, None] - base).clamp(0, 32)
    part = (torch.ones_like(keep) << keep.clamp(max=31)) - 1
    return torch.where(keep == 0, 0, torch.where(keep == 32, _U32, part))


def _inblock(focc: FusedOccBP, words: torch.Tensor, c: torch.Tensor,
             off: torch.Tensor) -> torch.Tensor:
    cbits = (c[:, None] >> torch.arange(focc.NPLANES, device=c.device)) & 1
    e = (cbits - 1) & _U32                       # ~0 where c's bit is 0
    m = _planes(focc, words) ^ e[:, :, None]
    match = m[:, 0]
    for p in range(1, focc.NPLANES):
        match = match & m[:, p]                  # [B, plane_words]
    return popcount32(match & prefix_mask(off, focc.plane_words())).sum(1)


def _occ(focc: FusedOccBP, words: torch.Tensor, c: torch.Tensor):
    k = focc.occ_word()
    return words[:, k:k + focc.sigma].gather(1, c[:, None]).squeeze(1)


def access(focc: FusedOccBP, i: torch.Tensor) -> torch.Tensor:
    """bwt[i] for a batch of positions."""
    words, off = _words(focc, i)
    return _symbol(focc, words, off)


def rank(focc: FusedOccBP, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[j] in bwt[0:i[j])."""
    words, off = _words(focc, i)
    return _occ(focc, words, c) + _inblock(focc, words, c, off)


def lf_step(focc: FusedOccBP, r: torch.Tensor):
    """Extended LF: (sym, r') with sym = bwt[r], r' = C[sym] + rank(sym, r),
    all from one row per lane."""
    words, off = _words(focc, r)
    sym = _symbol(focc, words, off)
    r2 = ((focc.C.long() & _U32)[sym] + _occ(focc, words, sym)
          + _inblock(focc, words, sym, off))
    return sym, r2


def rank_all_batch_bp(focc: FusedOccBP, i: torch.Tensor) -> torch.Tensor:
    """[B, sigma] int64: the occurrences of every symbol in bwt[0:i[j])
    from one row gather.  Port of ``bwtb3m_tpu/ops/focc_bp.py::
    rank_all_batch_bp``: the checkpoint words carry all sigma counts, and
    each symbol's in-block count is the popcount of its match word over
    the same plane words (what the bidirectional index's smaller-symbol
    sums read)."""
    words, off = _words(focc, i.long())
    k = focc.occ_word()
    occ = words[:, k:k + focc.sigma]                       # [B, sigma]
    cs = torch.arange(focc.sigma, device=i.device)
    cbits = (cs[:, None] >> torch.arange(focc.NPLANES, device=i.device)) & 1
    e = (cbits - 1) & _U32                                 # [sigma, planes]
    m = _planes(focc, words)[:, None] ^ e[None, :, :, None]
    match = m[:, :, 0]
    for p in range(1, focc.NPLANES):
        match = match & m[:, :, p]                         # [B, sigma, w]
    mask = prefix_mask(off, focc.plane_words())[:, None]
    return occ + popcount32(match & mask).sum(2)
