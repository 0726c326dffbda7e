"""Wavelet rank rows for alphabets past 256 symbols.

Port of ``bwtb3m_tpu/ops/rank.py`` (``OccTable``: ``_build_occ_jax``,
``rank_batch``, ``access_batch``, ``occ_total_counts``) and of
``ops/lf.py::lf_step_batch`` over it.  The reference keeps an int32 count
of every symbol for every 128-symbol block, (4 sigma / 128 + 4) bytes a
symbol: 62.5 GB of counts for 400 M symbols over 5,000 symbols.  The C++
tool it stands for answers these ranks with a wavelet tree; here the
alphabet's ``levels`` = ceil(log2 sigma) bit levels form a wavelet
matrix, a few bits a symbol per level, which computes the same
functions: access, rank and LF.

Level 0 holds the most significant bit of every BWT symbol, in BWT
order.  The sequence of level l + 1 is level l's, stably partitioned by
the bit of level l: zeros first, then ones.  ``Z[l]`` is the number of
zeros of level l.  A descent from position i reads, at each level, the
bit b at i and the ones before it, and goes on at ``Z[l] + ones`` (b = 1)
or ``i - ones`` (b = 0): along BWT[i]'s own bits it is ``access`` and the
LF step at once, along a symbol c's bits it is ``rank(c, i)``.  Where the
descent ends, f, the symbols lie in order of their bit-reversed values,
so symbol c's run starts at ``start[c]`` and

    rank(c, i) = f - start[c],     LF(i) = C[sym] + rank(sym, i) = D[sym] + f

with ``D[c] = C[c] - start[c]``.

A level is stored in 32-byte sectors, the unit of a random read on the
card: word 0 is the count of ones before the sector, words 1..7 hold the
next 224 bits, LSB first.  A descent therefore reads one sector per
level.  A level has ``n // 224 + 1`` sectors, so that position n (a rank
of n) has one.  At 400 M symbols over 5,000 symbols (13 levels) that is
743 MB.

The plain functions below are the CPU path and the version the CUDA
kernels (``csrc/focc_rows.cuh::WaveletRows``, in ``csrc/lf_walk.cu`` and
``csrc/gap_chain.cu``) are held against: they read the very sectors the
kernels read.  Positions and ranks stay below 2^31, as the reference's
int32 lanes do; ``build_wavelet`` refuses longer texts.  The reference's
``rank_all_symbols_batch`` and ``backward_search_step`` have no caller
yet (ROADMAP.md, items 8b and 8c).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from .focc_bp import popcount32, prefix_mask

SECTOR_BITS = 224
SECTOR_WORDS = 8              # the ones before the sector + 7 bit words
MAX_SYMBOLS = 1 << 16         # 16 levels at most
_U32 = 0xFFFFFFFF


# D or start, one uint32 per symbol, go to shared memory up to the 48 KB
# a block takes without opting in (12,288 symbols)
SMEM_LIMIT = 48 * 1024


def smem_bytes(sigma: int) -> int:
    """Shared memory a kernel over wavelet rows stages its table in:
    sigma words, or 0 (read with __ldg) past ``SMEM_LIMIT``."""
    return 4 * sigma if 4 * sigma <= SMEM_LIMIT else 0


def levels_for(sigma: int) -> int:
    """Bit levels of a dense alphabet of ``sigma`` symbols (at least 1)."""
    return max(1, (int(sigma) - 1).bit_length())


@dataclasses.dataclass
class WaveletRows:
    """The wavelet matrix of a BWT over the dense alphabet [0, sigma)."""

    sectors: torch.Tensor     # int32 [levels, nsec, 8], uint32 bits
    Z: torch.Tensor           # int32 [levels]: zeros of each level
    start: torch.Tensor       # int32 [sigma]: start of c's run at the end
    D: torch.Tensor           # int32 [sigma]: C[c] - start[c]
    C: torch.Tensor           # int64 [sigma + 1]
    n: int
    sigma: int

    LAYOUT: ClassVar[str] = "wavelet"
    MAX_SIGMA: ClassVar[int] = MAX_SYMBOLS

    @property
    def levels(self) -> int:
        return self.sectors.shape[0]

    @property
    def nsec(self) -> int:
        return self.sectors.shape[1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.sectors, self.Z, self.start, self.D,
                             self.C))


def symbol_values(t: torch.Tensor) -> torch.Tensor:
    """int64 symbols of a symbol tensor; int16 tensors hold uint16 bits
    (the dense text and region symbols past 256 symbols travel so: torch
    has little uint16 arithmetic)."""
    v = t.long()
    return v & 0xFFFF if t.dtype == torch.int16 else v


def as_u16_bits(t: torch.Tensor) -> torch.Tensor:
    """Symbols in [0, 2^16) as the int16 tensor of their uint16 bits."""
    if t.dtype == torch.int16:
        return t
    v = t.long()
    return torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)


def _bit_reversed(c: torch.Tensor, levels: int) -> torch.Tensor:
    out = torch.zeros_like(c)
    for l in range(levels):
        out |= ((c >> l) & 1) << (levels - 1 - l)
    return out


def _pack_level(bits: torch.Tensor, n: int, nsec: int) -> torch.Tensor:
    """[nsec, 8] int32 sectors of one level's 0/1 bits (uint8 [n])."""
    dev = bits.device
    padded = torch.zeros(nsec * SECTOR_BITS, dtype=torch.uint8, device=dev)
    padded[:n] = bits
    by = padded.view(-1, 8)
    packed = by[:, 0].clone()
    for k in range(1, 8):
        packed |= by[:, k] << k
    ones = padded.view(nsec, SECTOR_BITS).sum(1)
    out = torch.empty((nsec, SECTOR_WORDS), dtype=torch.int32, device=dev)
    out[:, 0] = (torch.cumsum(ones, 0) - ones).to(torch.int32)
    out[:, 1:] = packed.view(nsec, 4 * (SECTOR_WORDS - 1)).view(torch.int32)
    return out


def build_wavelet(bwt: torch.Tensor, sigma: int) -> WaveletRows:
    """The wavelet rows of a BWT of dense symbols in [0, sigma), built
    on the tensor's device with torch: per level a bit extraction, the
    sector packing and one stable partition.  ``bwt`` is any integer
    tensor; int16 holds uint16 bits."""
    n = int(bwt.shape[0])
    sigma = int(sigma)
    if n >= 1 << 31:
        raise ValueError("wavelet rows keep positions below 2^31 (the "
                         "reference's int32 lanes): n=%d" % n)
    if not 1 <= sigma <= MAX_SYMBOLS:
        raise ValueError("wavelet rows hold 1 to %d symbols, not %d"
                         % (MAX_SYMBOLS, sigma))
    dev = bwt.device
    levels = levels_for(sigma)
    nsec = n // SECTOR_BITS + 1
    sectors = torch.empty((levels, nsec, SECTOR_WORDS), dtype=torch.int32,
                          device=dev)
    seq = symbol_values(bwt).to(torch.int32)
    hist = torch.bincount(seq, minlength=sigma)[:sigma]
    if n and int(seq.max()) >= sigma:
        raise ValueError("BWT symbols outside [0, %d)" % sigma)
    Z = torch.empty(levels, dtype=torch.int32, device=dev)
    for l in range(levels):
        bit = ((seq >> (levels - 1 - l)) & 1).to(torch.uint8)
        sectors[l] = _pack_level(bit, n, nsec)
        one = bit.bool()
        Z[l] = n - int(one.sum())
        if l + 1 < levels:
            seq = torch.cat([seq[~one], seq[one]])
        del bit, one
    del seq
    C = torch.zeros(sigma + 1, dtype=torch.int64, device=dev)
    C[1:] = torch.cumsum(hist, 0)
    key = _bit_reversed(torch.arange(sigma, device=dev), levels)
    order = torch.argsort(key)
    start = torch.empty(sigma, dtype=torch.int64, device=dev)
    start[order] = torch.cumsum(hist[order], 0) - hist[order]
    return WaveletRows(sectors.contiguous(), Z, start.to(torch.int32),
                       (C[:sigma] - start).to(torch.int32), C, n, sigma)


def build_wavelet_host(bwt: np.ndarray, sigma: int, device) -> WaveletRows:
    """``build_wavelet`` of a host BWT of dense symbols, on ``device``."""
    arr = np.asarray(bwt)
    if arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
    return build_wavelet(t.to(device), sigma)


# ------------------------------------------------------------ plain queries

def _level(wm: WaveletRows, l: int, i: torch.Tensor):
    """(ones before i, bit at i) of level l for int64 positions i."""
    sec = i // SECTOR_BITS
    off = i - sec * SECTOR_BITS
    row = wm.sectors[l][sec]                       # [B, 8]
    words = row[:, 1:].long() & _U32
    ones = (row[:, 0].long() & _U32) + popcount32(
        words & prefix_mask(off, SECTOR_WORDS - 1)).sum(1)
    word = words.gather(1, (off >> 5)[:, None]).squeeze(1)
    return ones, (word >> (off & 31)) & 1


def _descend(wm: WaveletRows, i: torch.Tensor,
             c: Optional[torch.Tensor] = None):
    """(symbol, end position f) of the descent from positions i: along
    BWT[i]'s bits, or along the bits of the symbols ``c``."""
    i = i.long()
    sym = torch.zeros_like(i)
    Z = wm.Z.long()
    L = wm.levels
    for l in range(L):
        ones, bit = _level(wm, l, i)
        if c is not None:
            bit = (c >> (L - 1 - l)) & 1
        i = torch.where(bit == 1, Z[l] + ones, i - ones)
        sym = (sym << 1) | bit
    return sym, i


def access(wm: WaveletRows, i: torch.Tensor) -> torch.Tensor:
    """BWT[i] (int64) for a batch of positions in [0, n)."""
    return _descend(wm, i)[0]


def rank(wm: WaveletRows, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[j] in BWT[0 : i[j]) for positions in [0, n]."""
    c = c.long()
    _sym, f = _descend(wm, i, c)
    return f - wm.start.long()[c]


def lf_step(wm: WaveletRows, r: torch.Tensor):
    """Extended LF: (sym, r') with r' = C[sym] + rank(sym, r) = D[sym] + f,
    from one descent."""
    sym, f = _descend(wm, r)
    return sym, wm.D.long()[sym] + f


def occ_totals(wm: WaveletRows) -> torch.Tensor:
    """Occurrences of every symbol in the whole BWT (int64 [sigma])."""
    return wm.C[1:] - wm.C[:-1]


def occtable_bytes(n: int, sigma: int, block: int = 128) -> int:
    """Device bytes of the reference's ``OccTable`` for the same text:
    int32 counts of every symbol per block plus the int32 symbols."""
    nb = (n + block - 1) // block
    return 4 * (nb + 1) * sigma + 4 * nb * block + 4 * (sigma + 1)


def wavelet_from_jax(occt, symmap=None, device="cpu") -> WaveletRows:
    """The port's rows of the BWT that a reference ``OccTable`` holds
    (its dense symbols, read back through numpy, so this module needs no
    JAX import).  ``symmap`` is the map to the file's symbols that came
    with the table; the rows are over the dense symbols either way."""
    n, sigma = int(occt.n), int(occt.sigma)
    bwt = np.asarray(occt.bwt_blocks).reshape(-1)[:n].astype(np.int32)
    if symmap is not None and len(symmap) != sigma:
        raise ValueError("symmap of %d symbols for a table of %d"
                         % (len(symmap), sigma))
    return build_wavelet_host(bwt, sigma, device)
