"""The merge tree's zip: gap-guided interleave of two region BWTs on the
device, plus the region byte storage and the sample-rank helpers.

Port of ``bwtb3m_tpu/ops/devzip.py`` (narrow variants).  A region's BWT
lives on the device as flat packed bytes: LSB-first nibbles for
``bits=4`` (sigma <= 16), raw bytes for ``bits=8`` — the byte order of
``engine/checkpoint.py``'s region files — little-endian uint16 for
``bits=16`` (more than 256 distinct symbols) and little-endian uint32 for
``bits=32`` (more than 65,536, up to 2^21); builds past 256 symbols write
no checkpoints.  The reference's 2-D
[rows, 256] layout and its shape buckets were XLA:TPU limits.

Interleave semantics (the reference's gap-guided merge of two BWT
streams, arXiv:1604.06687): for r = 0..B emit gap[r] left symbols, then
(while r < B) right[r].  With cnt_le = cumsum(gap), right symbol r goes
to output slot F(r) = r + cnt_le[r] (strictly increasing) and the left
symbols fill the other slots in order.  The reference's 33-step binary
search for the right symbols before an output position becomes
``torch.searchsorted`` over F, and its exclusive row sums
(``gap_row_cum_excl``) are subsumed by the one cumsum.  The output is
written in chunks of ``chunk`` symbols, so the transients stay O(chunk)
beside the O(B) cumsum.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .pack import pack_bits, unpack_bits
from .wavelet_rows import U16_SYMBOLS

ZIP_CHUNK = 1 << 26


def bits_for(sigma: int) -> int:
    return (4 if sigma <= 16 else 8 if sigma <= 256
            else 16 if sigma <= U16_SYMBOLS else 32)


def pack_region(bwt: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 symbols (int16 for ``bits=16``, int32 for ``bits=32``) ->
    region bytes (padded with 0 to whole bytes)."""
    if bits >= 16:
        return pack_bits(bwt, bits)
    pad = (-bwt.shape[0]) % (8 // bits)
    if pad:
        bwt = torch.cat([bwt, torch.zeros(pad, dtype=bwt.dtype,
                                          device=bwt.device)])
    return pack_bits(bwt, bits)


def rows_from_host_bwt(bwt: np.ndarray, sigma: int, device) -> torch.Tensor:
    """Host uint8 BWT -> region bytes on ``device``."""
    t = torch.from_numpy(np.require(bwt, np.uint8, "CW"))
    return pack_region(t, bits_for(sigma)).to(device)


def rows_to_host_bwt(packed: torch.Tensor, n: int, bits: int) -> np.ndarray:
    """Region bytes -> host uint8 [n] (uint16 for ``bits=16``, uint32 for
    ``bits=32``; one packed download)."""
    out = unpack_bits(packed.cpu(), bits, n).numpy()
    return out.view({16: np.uint16, 32: np.uint32}[bits]) if bits >= 16 \
        else out


def gap_cum(gap: torch.Tensor) -> torch.Tensor:
    """cnt_le[r] = number of left suffixes with R <= r (int64, inclusive
    cumsum of the histogram).  An int32 histogram is the narrow chain's,
    whose cells are uint32: a cell counts left suffixes, up to the whole
    left block (a poly-A block against a right block without A puts all
    of it into one cell), which the narrow chain keeps below 2^32
    (``engine/merge_scaled.py::_is_wide``).  Its cells are read so in the
    int64 copy, whose cumsum is then taken in place."""
    if gap.dtype != torch.int32:
        return torch.cumsum(gap, 0, dtype=torch.int64)
    cum = gap.long()
    cum &= 0xFFFFFFFF
    return cum.cumsum_(0)


def zip_plan(gap: torch.Tensor, B: int, ts: np.ndarray, ranks: np.ndarray,
             cnt_le: torch.Tensor = None) -> Tuple[int, np.ndarray,
                                                    np.ndarray]:
    """(histogram total, #right symbols placed before each output
    position in ``ts``, cnt_le at ``ranks``) — the reference's
    ``zip_plan``."""
    if cnt_le is None:
        cnt_le = gap_cum(gap)
    dev = cnt_le.device
    total = int(cnt_le[-1]) if len(cnt_le) else 0
    F = torch.arange(B, device=dev) + cnt_le[:B]
    r_starts = torch.searchsorted(
        F, torch.from_numpy(np.asarray(ts, np.int64)).to(dev))
    return total, r_starts.cpu().numpy(), cnt_le_at_ranks(gap, ranks, cnt_le)


def cnt_le_at_ranks(gap: torch.Tensor, ranks: np.ndarray,
                    cnt_le: torch.Tensor = None) -> np.ndarray:
    """cnt_le[r] (inclusive) at the given ranks."""
    if cnt_le is None:
        cnt_le = gap_cum(gap)
    idx = torch.from_numpy(np.asarray(ranks, np.int64)).to(cnt_le.device)
    return cnt_le[idx].cpu().numpy()


def device_interleave(left: torch.Tensor, A: int, right: torch.Tensor,
                      B: int, gap: torch.Tensor, bits: int,
                      cnt_le: torch.Tensor = None,
                      chunk: int = ZIP_CHUNK) -> torch.Tensor:
    """Region bytes of the merge of ``left`` (A symbols) and ``right``
    (B symbols) by the histogram ``gap`` (B + 1 cells summing to A)."""
    if cnt_le is None:
        cnt_le = gap_cum(gap)
    dev = gap.device
    lsym = unpack_bits(left, bits, A)
    rsym = unpack_bits(right, bits, B)
    total = A + B
    F = torch.arange(B, device=dev)
    F += cnt_le[:B]           # in place: one int64 of B, not two
    ts = torch.arange(0, total + chunk, chunk, device=dev).clamp(max=total)
    r_b = torch.searchsorted(F, ts).cpu().tolist()
    ts = ts.cpu().tolist()
    out = torch.empty(total, dtype=lsym.dtype, device=dev)
    for c in range(len(ts) - 1):
        t0, t1 = ts[c], ts[c + 1]
        if t1 <= t0:
            break
        r0, r1 = r_b[c], r_b[c + 1]
        seg = out[t0:t1]
        is_right = torch.zeros(t1 - t0, dtype=torch.bool, device=dev)
        loc = F[r0:r1] - t0
        is_right[loc] = True
        seg[loc] = rsym[r0:r1]
        seg[~is_right] = lsym[t0 - r0:t1 - r1]
    # the inputs go before the packing allocates: a merge's peak is then
    # a chunk's, not the packing's on top of everything
    del lsym, rsym, F, seg, is_right, loc
    return pack_region(out, bits)
