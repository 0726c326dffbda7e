"""Build the fused rank rows on the target device.

Port of ``bwtb3m_tpu/ops/focc_build.py``: ``build_focc_host`` (from a
host BWT) and ``build_focc_from_rows`` (from a merge region's packed BWT
bytes already on the device, here ``build_focc_from_packed``).  The
reference streams the BWT through fixed-shape chunk programs and pads the
row count
to a few compiled shapes; neither is needed here (PyTorch compiles no
shape), so the rows are built in one pass per step and cover exactly
blocks [0, nb].  Rows 0..nb and C are byte-identical to the reference's
(pinned by tests/test_torch_focc.py): pad positions past n hold symbol 0
in the rows and are never counted.

The build is per-block counting (one compare-and-sum per symbol), an
exclusive cumsum over blocks, and shift-sum passes for the plane bytes
and the little-endian count bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .focc import FusedOcc, _row_width
from .focc_bp import NPLANES, OCC_WORD, ROW_BYTES, FusedOccBP

BLOCK = 256


def _occ_bytes(occ: torch.Tensor) -> torch.Tensor:
    """[rows, sigma] int64 counts -> [rows, 4*sigma] little-endian bytes."""
    shifts = 8 * torch.arange(4, device=occ.device)
    return ((occ[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(
        occ.shape[0], -1)


def build_focc_host(bwt: np.ndarray, sigma: int, device):
    """Rank rows for a host uint8 BWT over symbols [0, sigma), built on
    ``device``: bit-plane rows for sigma <= 8, byte rows up to 256."""
    bwt = np.require(bwt, np.uint8, "CW")
    return build_focc_device(torch.from_numpy(bwt).to(device), sigma)


def build_focc_from_packed(packed: torch.Tensor, n: int, sigma: int,
                           bits: int):
    """Rank rows of a merge region from its packed BWT bytes on the
    device (``ops/devzip.py`` layout: LSB-first nibbles for ``bits=4``,
    raw bytes for 8).  Rows 0..nb and C equal ``build_focc_host`` on the
    unpacked symbols, as the reference's ``build_focc_from_rows`` equals
    its host builder."""
    from .pack import unpack_bits
    return build_focc_device(unpack_bits(packed, bits, n), sigma)


def build_focc_device(bwt: torch.Tensor, sigma: int):
    """Rank rows of a uint8 BWT tensor, built on its device."""
    if sigma > 256:
        raise ValueError("fused rank rows store symbols as bytes "
                         "(sigma <= 256)")
    n = bwt.shape[0]
    if n >= 1 << 31:
        raise ValueError("rank rows hold uint32 counts read as int32 "
                         "here: n < 2^31")
    device = bwt.device
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    nrows = nb + 1
    sym = torch.full((nrows * BLOCK,), -1, dtype=torch.int16, device=device)
    sym[:n] = bwt
    blocks = sym.view(nrows, BLOCK)               # pad positions are -1
    per_block = torch.stack([(blocks == c).sum(1) for c in range(sigma)],
                            dim=1)                # int64 [nb+1, sigma]
    occ = per_block.cumsum(0) - per_block         # exclusive; row nb = totals
    total = per_block.sum(0)
    C = torch.zeros(sigma + 1, dtype=torch.int64, device=device)
    C[1:] = total.cumsum(0)
    syms8 = blocks.clamp(min=0).to(torch.uint8)   # pad positions store 0

    if sigma <= 8:
        # bit p of 8 consecutive symbols -> one byte, LSB first, so the
        # 32 bytes of a plane read as the 8 little-endian plane words
        s = syms8.view(nrows, BLOCK // 8, 8).to(torch.int32)
        weights = 1 << torch.arange(8, device=device, dtype=torch.int32)
        planes = torch.stack(
            [(((s >> p) & 1) * weights).sum(-1) for p in range(NPLANES)],
            dim=1)                                # [nb+1, 3, 32] in 0..255
        rows = torch.zeros((nrows, ROW_BYTES), dtype=torch.uint8,
                           device=device)
        rows[:, :4 * OCC_WORD] = planes.to(torch.uint8).view(nrows, -1)
        rows[:, 4 * OCC_WORD:4 * OCC_WORD + 4 * sigma] = _occ_bytes(occ)
        return FusedOccBP(rows, C.to(torch.int32), n, sigma)

    roww = _row_width(sigma, BLOCK)
    rows = torch.zeros((nrows, roww), dtype=torch.uint8, device=device)
    rows[:, :BLOCK] = syms8
    rows[:, BLOCK:BLOCK + 4 * sigma] = _occ_bytes(occ)
    return FusedOcc(rows, C.to(torch.int32), n, sigma)


def focc_from_jax(jax_focc, device="cpu"):
    """Carry a reference ``FusedOccBP`` / ``FusedOcc`` over to the port:
    rows viewed as uint8 and trimmed to blocks [0, nb], plus C.  Takes the
    arrays through numpy, so this module needs no JAX import."""
    n, sigma = int(jax_focc.n), int(jax_focc.sigma)
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    rows = np.asarray(jax_focc.rows).view(np.uint8)[:nb + 1]
    rows_t = torch.from_numpy(np.array(rows)).to(device)
    C = torch.from_numpy(
        np.asarray(jax_focc.C).astype(np.int64)).to(torch.int32).to(device)
    if rows.shape[1] == ROW_BYTES:
        return FusedOccBP(rows_t, C, n, sigma)
    return FusedOcc(rows_t, C, n, sigma)
