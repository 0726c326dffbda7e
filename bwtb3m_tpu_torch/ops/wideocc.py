"""Rank queries for texts of 2^32 symbols or more: the wide rank rows.

Port of ``bwtb3m_tpu/ops/wideocc.py``.  The fused rank rows store each
occ checkpoint as a uint32 word, exact below 2^32 and wrapped past it.
The rows stay byte for byte the narrow rows; beside them sit

    thr   int64 [sigma, THR_K]: the block rows (in the layout's own block
          unit: 64 symbols on sector rows, 256 otherwise) at which each
          symbol's stored occ word wrapped, padded with 0xFFFFFFFF
    C     int64 [sigma + 1]: the full C array

and the hi word of a checkpoint is derived: occ_c is nondecreasing in
the block row and a block adds fewer than 2^32 occurrences, so

    occ(c, row) = (#{k : thr[c, k] <= row} << 32) + stored lo word.

A wide query is the narrow query (lo word + in-block count, read as
int64: their sum carries by itself) plus that hi term, and the LF step
adds the int64 C.  There are no (hi, lo) pairs and no carry discipline:
torch has int64, and so has the kernel (``csrc/focc_rows.cuh``, the
64-bit forms of ``csrc/lf_walk.cu`` and ``csrc/gap_chain.cu``, which
keep ``thr`` in shared memory).

The builders (``ops/focc_build.py``) carry an exact int64 running count
per symbol from one chunk of the BWT to the next, so the wrap rows are
read off the counts as they are made (``find_wrap_rows``): the
reference's binary search over the device rows between chunk bases is
not needed.  With THR_K = 8 wraps per symbol the structure is exact to
n = 2^35 symbols.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .focc import access, as_u32_bits, rank
from .focc_bp import FusedOccBP

THR_K = 8          # wraps tracked per symbol: exact to n = 2^35
THR_PAD = 0xFFFFFFFF


@dataclasses.dataclass
class WideOcc:
    """Narrow rank rows (lo words) + wrap rows + the int64 C array."""

    focc: object              # FusedOccSector, FusedOccBP or FusedOcc
    thr: torch.Tensor         # int64 [sigma, THR_K], THR_PAD where unused
    C: torch.Tensor           # int64 [sigma + 1]
    n: int

    @property
    def sigma(self) -> int:
        return self.focc.sigma

    @property
    def LAYOUT(self) -> str:
        return self.focc.LAYOUT

    @property
    def SHIFT(self) -> int:
        return self.focc.SHIFT

    @property
    def rows(self) -> torch.Tensor:
        return self.focc.rows


def occ_words_from_row(focc, row: torch.Tensor) -> np.ndarray:
    """The occ checkpoint lo words (uint32 [sigma]) of one rank row, on
    the host."""
    b = np.ascontiguousarray(row.cpu().numpy(), np.uint8)
    if isinstance(focc, FusedOccBP):
        k = 4 * focc.occ_word()
    else:
        k = 1 << focc.SHIFT
    return b[k:k + 4 * focc.sigma].view("<u4").copy()


def find_wrap_rows(occ: torch.Tensor, row0: int,
                   prev_hi: torch.Tensor) -> List[np.ndarray]:
    """Per symbol, the rows among ``row0, row0 + 1, ...`` at which the
    exact running count ``occ`` (int64 [rows, sigma]) crosses a multiple
    of 2^32, one entry per multiple crossed; ``prev_hi`` (int64 [sigma])
    is the hi word of the row before ``row0`` (0 before row 0, so a
    count that starts at or above 2^32 gives entries at row 0)."""
    hi = occ >> 32
    step = hi - torch.cat([prev_hi[None, :], hi[:-1]])
    out = []
    for c in range(occ.shape[1]):
        at = torch.nonzero(step[:, c]).reshape(-1)
        out.append(np.repeat(at.cpu().numpy() + row0,
                             step[at, c].cpu().numpy()))
    return out


def widen_focc(focc, wraps: List[np.ndarray], totals: torch.Tensor,
               n: int) -> WideOcc:
    """Assemble a ``WideOcc`` from freshly built narrow rows, each
    symbol's wrap rows (``find_wrap_rows`` over every chunk) and the
    exact symbol totals (int64 [sigma])."""
    sigma = focc.sigma
    thr = np.full((sigma, THR_K), THR_PAD, np.int64)
    for c, rows in enumerate(wraps):
        if len(rows) > THR_K:
            raise ValueError("symbol %d wraps its occ word %d times: the "
                             "wide rank rows track %d (n < 2^35)"
                             % (c, len(rows), THR_K))
        thr[c, :len(rows)] = rows
    dev = focc.rows.device
    C = torch.zeros(sigma + 1, dtype=torch.int64, device=dev)
    C[1:] = totals.to(dev).cumsum(0)
    return WideOcc(focc, torch.from_numpy(thr).to(dev), C, int(n))


def hi_words(w: WideOcc, c: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """#{k : thr[c[j], k] <= row[j]} (int64)."""
    return (w.thr[c] <= row[:, None]).sum(1)


def rank_w(w: WideOcc, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[j] in bwt[0 : i[j]) (int64)."""
    return rank(w.focc, c, i) + (hi_words(w, c, i >> w.SHIFT) << 32)


def access_w(w: WideOcc, i: torch.Tensor) -> torch.Tensor:
    """bwt[i] (int64)."""
    return access(w.focc, i)


def lf_step_w(w: WideOcc, r: torch.Tensor):
    """Extended LF: (sym, C[sym] + rank(sym, r)), int64."""
    sym = access(w.focc, r)
    return sym, w.C[sym] + rank_w(w, sym, r)


def kernel_tables(w: WideOcc):
    """(thr as int32 uint32 bits [sigma * THR_K], C int64 [sigma]): what
    the 64-bit kernel forms stage in shared memory."""
    return (as_u32_bits(w.thr.reshape(-1)).contiguous(),
            w.C[:w.sigma].contiguous())


def wide_from_jax(jax_w, device="cpu", layout: str = "auto") -> WideOcc:
    """Carry a reference ``WideOcc`` over to the port, in any layout: its
    int64 C from (C_hi, C_lo); in the reference's own layout its rows as
    they are and its wrap rows; else (sector rows) rows rebuilt from the
    symbols, starting from the reference's exact counts at row 0 (its
    hi word from the wrap rows, its lo word from the row)."""
    from .focc_build import build_focc_device, focc_from_jax, resolve_layout

    jf = jax_w.focc
    sigma = int(jf.sigma)
    c64 = ((np.asarray(jax_w.C_hi).astype(np.int64) << 32)
           | np.asarray(jax_w.focc.C).astype(np.int64))
    thr = np.asarray(jax_w.thr).astype(np.int64)
    own = "bitplane" if np.asarray(jf.rows).shape[1] == 128 else "bytes"
    if resolve_layout(layout, sigma) == own:
        focc = focc_from_jax(jf, device, own)
        return WideOcc(focc, torch.from_numpy(thr).to(device),
                       torch.from_numpy(c64).to(device), int(jax_w.n))
    narrow = focc_from_jax(jf, device, own)
    lo0 = occ_words_from_row(narrow, narrow.rows[0]).astype(np.int64)
    base = ((thr <= 0).sum(1) << 32) + lo0
    bwt = access(narrow, torch.arange(narrow.n, device=device)).to(
        torch.uint8)
    return build_focc_device(bwt, sigma, layout, wide=True,
                             base=torch.from_numpy(base))


def doctored(bwt: torch.Tensor, sigma: int, layout: str,
             base: torch.Tensor) -> WideOcc:
    """Wide rows whose occ counts straddle 2^32 without 2^32 symbols: the
    rows of ``bwt`` as the tail of a text with ``base[c]`` earlier
    occurrences of each symbol (the reference's tests/test_wideocc.py
    doctors its rows so), and a C lowered by ``base``, so that an LF step
    still lands on the rank the undoctored rows give: every rank query
    reads a hi word from the wrap rows, and a walk stays inside the BWT.
    What the tests and ``chip_smoke.py`` hold the 64-bit kernel forms to
    their plain versions on."""
    from .focc_build import build_focc_device

    w = build_focc_device(bwt, sigma, layout, wide=True, base=base)
    base = base.to(w.C.device)
    shift = torch.zeros_like(w.C)
    shift[1:] = base.cumsum(0)
    w.C = w.C - shift
    w.C[:sigma] -= base
    return w
