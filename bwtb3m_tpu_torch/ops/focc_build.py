"""Build the fused rank rows on the target device.

Port of ``bwtb3m_tpu/ops/focc_build.py``: ``build_focc_host`` (from a
host BWT) and ``build_focc_from_rows`` (from a merge region's packed BWT
bytes already on the device, here ``build_focc_from_packed``).  The
reference streams the BWT through fixed-shape chunk programs and pads the
row count
to a few compiled shapes; neither is needed here (PyTorch compiles no
shape), so the rows are built in one pass per step and cover exactly
blocks [0, nb].

Every build function takes ``layout``: ``"sector"`` (32-byte rows of 64
symbols, sigma <= 4, ``focc_bp.FusedOccSector``), ``"bitplane"``
(128-byte rows of 256 symbols, sigma <= 8, ``focc_bp.FusedOccBP``),
``"bytes"`` (byte rows, sigma <= 256, ``focc.FusedOcc``) or ``"auto"``,
the default: the narrowest of the three that holds sigma.  With
``"bitplane"`` / ``"bytes"`` rows 0..nb and C are byte-identical to the
reference's (pinned by tests/test_torch_focc.py); sector rows hold the
same planes and counts at a quarter of the block.  Pad positions past n
hold symbol 0 in the rows and are never counted.

The build is one running count per symbol (a cumsum of a compare) read
at the block starts, a multiply that gathers the plane bits of 8 symbols
into a byte, and a shift pass for the little-endian count bytes; none of
them depends on the block size, so sector rows cost what bit-plane rows
do.
"""

from __future__ import annotations

import numpy as np
import torch

from .focc import BLOCK, FusedOcc, _row_width, as_u32_bits
from .focc_bp import FusedOccBP, FusedOccSector
from .pack import unpack_bits

LAYOUTS = {"sector": FusedOccSector, "bitplane": FusedOccBP,
           "bytes": FusedOcc}


def resolve_layout(layout: str, sigma: int) -> str:
    """``"auto"`` -> the narrowest layout that holds ``sigma``; a named
    layout is checked against its alphabet limit."""
    if sigma > 256:
        raise ValueError("fused rank rows store symbols as bytes "
                         "(sigma <= 256)")
    if layout == "auto":
        return next(k for k, cls in LAYOUTS.items()
                    if sigma <= cls.MAX_SIGMA)
    if layout not in LAYOUTS:
        raise ValueError("layout must be auto, sector, bitplane or bytes, "
                         "not %r" % (layout,))
    if sigma > LAYOUTS[layout].MAX_SIGMA:
        raise ValueError("layout %s holds sigma <= %d, not %d"
                         % (layout, LAYOUTS[layout].MAX_SIGMA, sigma))
    return layout


def _occ_bytes(occ: torch.Tensor) -> torch.Tensor:
    """[rows, sigma] int64 counts -> [rows, 4*sigma] little-endian bytes."""
    shifts = 8 * torch.arange(4, device=occ.device)
    return ((occ[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(
        occ.shape[0], -1)


def build_focc_host(bwt: np.ndarray, sigma: int, device,
                    layout: str = "auto", wide: bool = False):
    """Rank rows for a host uint8 BWT over symbols [0, sigma), built on
    ``device`` in ``layout`` (module docstring); with ``wide`` the
    ``ops/wideocc.py::WideOcc`` over them."""
    bwt = np.require(bwt, np.uint8, "CW")
    return build_focc_device(torch.from_numpy(bwt).to(device), sigma, layout,
                             wide=wide)


def build_focc_from_packed(packed: torch.Tensor, n: int, sigma: int,
                           bits: int, layout: str = "auto",
                           wide: bool = False):
    """Rank rows of a merge region from its packed BWT bytes on the
    device (``ops/devzip.py`` layout: LSB-first nibbles for ``bits=4``,
    raw bytes for 8).  Rows and C equal ``build_focc_host`` on the
    unpacked symbols, as the reference's ``build_focc_from_rows`` equals
    its host builder."""
    return build_focc_device(unpack_bits(packed, bits, n), sigma, layout,
                             wide=wide)


# (x * _GATHER) >> 56 collects bit 0 of each of the 8 bytes of an int64
# word x into one byte, byte k -> bit k (no two partial products meet, so
# nothing carries); as a signed constant
_GATHER = sum(1 << (56 - 7 * k) for k in range(8))
_BIT0 = 0x0101010101010101
# symbols counted per pass of the running counts: the int32 cumsum of a
# pass stays exact and its transients stay at 5 bytes per pass symbol
OCC_CHUNK = 1 << 28


def _occ_chunks(bwt: torch.Tensor, sigma: int, block: int, nrows: int,
                running: torch.Tensor):
    """Yield (first row, occ int64 [rows, sigma]) for the rows of every
    chunk of ``OCC_CHUNK`` symbols: exact occurrences of each symbol
    before every block start (a block that starts at or past n gets the
    totals), counted on from ``running`` (int64 [sigma], the counts
    before position 0), which ends as the totals.  One running count per
    symbol, read at the block starts, so the cost does not depend on the
    block size."""
    n, device = bwt.shape[0], bwt.device
    g = OCC_CHUNK // block
    for r0 in range(0, nrows, g):
        r1 = min(nrows, r0 + g)
        seg = bwt[min(n, r0 * block):min(n, r1 * block)]
        occ = running.repeat(r1 - r0, 1)
        if len(seg):
            at = (torch.arange(1, r1 - r0, device=device) * block).clamp(
                max=len(seg)) - 1
            for c in range(sigma):
                run = torch.cumsum(seg == c, 0, dtype=torch.int32)
                occ[1:, c] += run[at]
                running[c] += run[-1]
        yield r0, occ


def build_focc_device(bwt: torch.Tensor, sigma: int, layout: str = "auto",
                      out: torch.Tensor = None, wide: bool = False,
                      base: torch.Tensor = None):
    """Rank rows of a uint8 BWT tensor, built on its device; into the
    zeroed ``out`` rows where given (``build_focc_concat``).  The occ
    words and C are the counts modulo 2^32 (exact for n < 2^32, the
    narrow kernels read them as uint32).  With ``wide``, the
    ``ops/wideocc.py::WideOcc`` over the same rows: the wrap rows of
    every symbol and the int64 C.  ``base`` (int64 [sigma]) counts
    occurrences before position 0, as if the BWT were the tail of a
    longer one: the tests' and ``chip_smoke.py``'s rows that straddle
    2^32 without 2^32 symbols."""
    from .wideocc import find_wrap_rows, widen_focc

    cls = LAYOUTS[resolve_layout(layout, sigma)]
    n = bwt.shape[0]
    device = bwt.device
    block = 1 << cls.SHIFT
    nrows = cls.num_rows(n)
    total = torch.zeros(sigma, dtype=torch.int64, device=device)
    if base is not None:
        total += base.to(device)
    if cls is FusedOcc:
        rows = _rows_out(out, nrows, _row_width(sigma, block), device)
        occ0 = block
    else:
        rows = _rows_out(out, nrows, cls.ROW_BYTES, device)
        occ0 = 4 * cls.occ_word()
    wraps = [[] for _ in range(sigma)]
    prev_hi = torch.zeros(sigma, dtype=torch.int64, device=device)
    for r0, occ in _occ_chunks(bwt, sigma, block, nrows, total):
        rows[r0:r0 + len(occ), occ0:occ0 + 4 * sigma] = _occ_bytes(occ)
        if wide:
            for c, at in enumerate(find_wrap_rows(occ, r0, prev_hi)):
                wraps[c].append(at)
            prev_hi = occ[-1] >> 32
    C = torch.zeros(sigma + 1, dtype=torch.int64, device=device)
    C[1:] = total.cumsum(0)

    sym = torch.zeros(nrows * block, dtype=torch.uint8, device=device)
    sym[:n] = bwt                                 # pad positions store 0
    if cls is FusedOcc:
        rows[:, :block] = sym.view(nrows, block)
    else:
        # bit p of 8 consecutive symbols -> one byte, LSB first, so the
        # bytes of a plane read as its little-endian plane words
        words = sym.view(torch.int64)             # symbol k in byte k
        planes = torch.stack(
            [(((((words >> p) & _BIT0) * _GATHER) >> 56) & 0xFF).to(
                torch.uint8).view(nrows, block // 8)
             for p in range(cls.NPLANES)], dim=1)  # [nrows, planes, block/8]
        rows[:, :occ0] = planes.view(nrows, -1)
        del words, planes
    del sym
    focc = cls(rows, as_u32_bits(C), n, sigma)
    if not wide:
        return focc
    return widen_focc(focc, [np.concatenate(w) if w else np.zeros(0, np.int64)
                             for w in wraps], total, n)


def _rows_out(out, nrows: int, roww: int, device) -> torch.Tensor:
    if out is None:
        return torch.zeros((nrows, roww), dtype=torch.uint8, device=device)
    if out.shape != (nrows, roww) or out.dtype != torch.uint8:
        raise ValueError("rows for %d x %d bytes, got %s"
                         % (nrows, roww, tuple(out.shape)))
    return out


def concat_layout(lens, sigma: int, layout: str = "auto"):
    """(layout class, row width, first row of each region, total rows) of
    ``build_focc_concat`` for regions of ``lens`` symbols."""
    cls = LAYOUTS[resolve_layout(layout, sigma)]
    roww = (_row_width(sigma, BLOCK) if cls is FusedOcc else cls.ROW_BYTES)
    nrows = [cls.num_rows(int(ln)) for ln in lens]
    first = np.concatenate([[0], np.cumsum(nrows)[:-1]]).astype(np.int64)
    return cls, roww, first, int(sum(nrows))


def build_focc_concat(packed, lens, sigma: int, bits: int,
                      layout: str = "auto"):
    """One rank structure over K regions, from their packed BWT bytes on
    the device: (focc, rbase int64 [K]).  Port of
    ``bwtb3m_tpu/ops/gapbatch.py::build_focc_concat_dev``.  Region k's
    rows, its trailing checkpoint row included, start at row
    rbase[k] / block and equal its own ``build_focc_from_packed`` rows:
    its running counts start at its first row, so the occ words are
    region-local, and a local rank r is queried at the global rank
    rbase[k] + r (block = 64 symbols on sector rows, 256 on the others).
    The kept checkpoint row is the gutter that keeps the regions' ranks,
    and so their cells of a level-wide histogram, apart.  ``focc.n`` is
    the rank space (total rows x block; one spare zero row follows) and
    ``focc.C`` is zero: the chains add their own ``c_first``."""
    cls, roww, first, total = concat_layout(lens, sigma, layout)
    device = packed[0].device
    rows = torch.zeros((total + 1, roww), dtype=torch.uint8, device=device)
    for k, (src, ln) in enumerate(zip(packed, lens)):
        a = int(first[k])
        build_focc_device(unpack_bits(src, bits, int(ln)), sigma, layout,
                          out=rows[a:a + cls.num_rows(int(ln))])
    C = torch.zeros(sigma + 1, dtype=torch.int32, device=device)
    return cls(rows, C, total << cls.SHIFT, sigma), first << cls.SHIFT


def focc_from_jax(jax_focc, device="cpu", layout: str = "auto"):
    """Carry a reference ``FusedOccBP`` / ``FusedOcc`` over to the port.
    Where ``layout`` resolves to the reference's own (``"bitplane"`` for
    its bit-plane rows, ``"bytes"`` for its byte rows) the rows are viewed
    as uint8 and trimmed to blocks [0, nb]; else (sector rows from the
    reference's bit-plane rows) the symbols are read back out of the
    planes and the rows rebuilt.  Takes the arrays through numpy, so this
    module needs no JAX import."""
    n, sigma = int(jax_focc.n), int(jax_focc.sigma)
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    rows = np.asarray(jax_focc.rows).view(np.uint8)[:nb + 1]
    have = "bitplane" if rows.shape[1] == FusedOccBP.ROW_BYTES else "bytes"
    if resolve_layout(layout, sigma) != have:
        if have == "bitplane":
            nbytes = 4 * FusedOccBP.occ_word()
            bits = np.unpackbits(
                rows[:, :nbytes].reshape(len(rows), FusedOccBP.NPLANES, -1),
                axis=-1, bitorder="little")       # [rows, planes, 256]
            syms = sum(bits[:, p] << p for p in range(FusedOccBP.NPLANES))
        else:
            syms = rows[:, :BLOCK]
        bwt = np.ascontiguousarray(syms.reshape(-1)[:n], np.uint8)
        return build_focc_host(bwt, sigma, device, layout)
    rows_t = torch.from_numpy(np.array(rows)).to(device)
    C = torch.from_numpy(
        np.asarray(jax_focc.C).astype(np.int64)).to(torch.int32).to(device)
    return LAYOUTS[have](rows_t, C, n, sigma)
