"""Wavelet rank rows for alphabets past 256 symbols.

Port of ``bwtb3m_tpu/ops/rank.py`` (``OccTable``: ``_build_occ_jax``,
``rank_batch``, ``access_batch``, ``occ_total_counts``) and of
``ops/lf.py::lf_step_batch`` over it.  The reference keeps an int32 count
of every symbol for every 128-symbol block, (4 sigma / 128 + 4) bytes a
symbol: 62.5 GB of counts for 400 M symbols over 5,000 symbols.  The C++
tool it stands for answers these ranks with a wavelet tree; here an
8-ary wavelet matrix of ``levels`` = ceil(bits(sigma - 1) / 3) levels,
three bits of the symbol per level, computes the same functions: access,
rank and LF.

A symbol's base-8 digits go one to a level, the most significant at
level 0, which holds them in BWT order.  The sequence of level l + 1 is
level l's, stably partitioned by the digit of level l: the 0s, then the
1s, ..., the 7s.  ``Zc[l][d]`` is the number of digits below d on level
l.  A descent from position i reads, at each level, the digit d at i and
``k = rank_d(i)``, the d digits before i, and goes on at
``Zc[l][d] + k``: along BWT[i]'s own digits it is ``access`` and the LF
step at once, along a symbol c's digits it is ``rank(c, i)``.  Where the
descent ends, f, the symbols lie in the order of their digit-reversed
values, so symbol c's run starts at ``start[c]`` and

    rank(c, i) = f - start[c],     LF(i) = C[sym] + rank(sym, i) = D[sym] + f

with ``D[c] = C[c] - start[c]``.

A level is stored in 64-byte blocks, 64-byte aligned: words 0..6 are the
counts of digits 0..6 before the block (the count of 7s is 96 b less
their sum), words 7..15 three bit planes of the next 96 digits, plane j
(bit j of each digit) in words 7 + 3j .. 9 + 3j, LSB first.  A descent
reads one block per level, two 32-byte sectors side by side: the card
fetches a random 64 bytes at nearly the cost of 32 (PERF.md), so the
walks pay per dependent read, and a step at 5,000 symbols makes 5 where
a binary matrix of 32-byte sectors makes 13 and a 4-ary one 7.  A level
has ``n // 96 + 1`` blocks, so that position n (a rank of n) has one.
At 400 M symbols over 5,000 symbols that is 1,333 MB.  The count of a
digit inside a block is ``digit_rank`` on each plane word triple: XOR
each plane with d's bit spread, AND the three, mask, popcount.

The plain functions below are the CPU path and the version the CUDA
kernels (``csrc/focc_rows.cuh::WaveletRows``, in ``csrc/lf_walk.cu`` and
``csrc/gap_chain.cu``) are held against: they read the very blocks the
kernels read, with the kernels' integer recipe.  Positions and ranks
stay below 2^31, as the reference's int32 lanes do; ``build_wavelet``
refuses longer texts.  ``backward_search_step`` over these rows is
``ops/lf.py``'s; ``rank_all`` (every symbol's rank at a batch of
positions, the reference's ``rank_all_symbols_batch``) is a level walk
that splits each node's position eight ways, reached through
``ops/rank.py``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from .focc_bp import popcount32

RADIX = 8                     # base-8 digits, three bits a level
DIGIT_BITS = 3
BLOCK_DIGITS = 96             # digits of a 64-byte block
BLOCK_WORDS = 16              # 7 digit counts + 3 planes of 3 words
COUNT_WORDS = RADIX - 1
PLANE_WORDS = 3
MAX_SYMBOLS = 1 << 16         # 6 levels at most
MAX_LEVELS = 6
_U32 = 0xFFFFFFFF


# D or start, one uint32 per symbol, go to shared memory up to the 48 KB
# a block takes without opting in, less the digit table that
# csrc/focc_rows.cuh::stage_wavelet holds there statically (RADIX words a
# level): 12,240 symbols
SMEM_LIMIT = 48 * 1024 - 4 * RADIX * MAX_LEVELS


def smem_bytes(sigma: int) -> int:
    """Shared memory a kernel over wavelet rows stages its table in:
    sigma words, or 0 (read with __ldg) past ``SMEM_LIMIT``."""
    return 4 * sigma if 4 * sigma <= SMEM_LIMIT else 0


def levels_for(sigma: int) -> int:
    """Levels of base-8 digits of a dense alphabet of ``sigma`` symbols
    (at least 1)."""
    return max(1, ((int(sigma) - 1).bit_length() + DIGIT_BITS - 1)
               // DIGIT_BITS)


@dataclasses.dataclass
class WaveletRows:
    """The 8-ary wavelet matrix of a BWT over the dense alphabet
    [0, sigma)."""

    blocks: torch.Tensor      # int32 [levels, nblk, 16], uint32 words
    Zc: torch.Tensor          # int32 [levels, 8]: digits below d per level
    start: torch.Tensor       # int32 [sigma]: start of c's run at the end
    D: torch.Tensor           # int32 [sigma]: C[c] - start[c]
    C: torch.Tensor           # int64 [sigma + 1]
    n: int
    sigma: int

    LAYOUT: ClassVar[str] = "wavelet"
    MAX_SIGMA: ClassVar[int] = MAX_SYMBOLS

    @property
    def levels(self) -> int:
        return self.blocks.shape[0]

    @property
    def nblk(self) -> int:
        return self.blocks.shape[1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.blocks, self.Zc, self.start, self.D,
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


def digit_rank(w: torch.Tensor, d: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Digits equal to d among the first ``keep`` (0..32) digits of one
    word of each bit plane, ``w[..., j]`` the word of plane j (uint32 in
    int64; d and keep broadcast against ``w[..., 0]``): each plane XOR
    ~0 where d's bit is 0 marks the digits whose bit j is d's, the AND of
    the three marks the digits equal to d, and the popcount below keep
    bits counts them.  The recipe of ``WaveletRows::level``."""
    match = None
    for j in range(DIGIT_BITS):
        e = (((d >> j) & 1) - 1) & _U32
        m = w[..., j] ^ e
        match = m if match is None else match & m
    return popcount32(match & ((torch.ones_like(keep) << keep) - 1))


def _digit_reversed(c: torch.Tensor, levels: int) -> torch.Tensor:
    """c with its ``levels`` base-8 digits in reverse order."""
    out = torch.zeros_like(c)
    for l in range(levels):
        out |= ((c >> (DIGIT_BITS * l)) & (RADIX - 1)) \
            << (DIGIT_BITS * (levels - 1 - l))
    return out


def _pack_level(dig: torch.Tensor, n: int, nblk: int) -> torch.Tensor:
    """[nblk, 16] int32 blocks of one level's digits (uint8 [n])."""
    dev = dig.device
    padded = torch.zeros(nblk * BLOCK_DIGITS, dtype=torch.uint8,
                         device=dev)
    padded[:n] = dig
    per = padded.view(nblk, BLOCK_DIGITS)
    out = torch.empty((nblk, BLOCK_WORDS), dtype=torch.int32, device=dev)
    for d in range(COUNT_WORDS):
        cnt = (per == d).sum(1)
        out[:, d] = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    for j in range(DIGIT_BITS):
        by = ((padded >> j) & 1).view(-1, 8)
        packed = by[:, 0].clone()
        for k in range(1, 8):
            packed |= by[:, k] << k
        w0 = COUNT_WORDS + PLANE_WORDS * j
        out[:, w0:w0 + PLANE_WORDS] = packed.view(
            nblk, 4 * PLANE_WORDS).view(torch.int32)
    return out


def build_wavelet(bwt: torch.Tensor, sigma: int) -> WaveletRows:
    """The wavelet rows of a BWT of dense symbols in [0, sigma), built
    on the tensor's device with torch: per level a 3-bit extraction, the
    block packing with its seven counts and one stable 8-way partition.
    ``bwt`` is any integer tensor; int16 holds uint16 bits."""
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
    nblk = n // BLOCK_DIGITS + 1
    blocks = torch.empty((levels, nblk, BLOCK_WORDS), dtype=torch.int32,
                         device=dev)
    seq = symbol_values(bwt).to(torch.int32)
    hist = torch.bincount(seq, minlength=sigma)[:sigma]
    if n and int(seq.max()) >= sigma:
        raise ValueError("BWT symbols outside [0, %d)" % sigma)
    Zc = torch.zeros((levels, RADIX), dtype=torch.int32, device=dev)
    for l in range(levels):
        dig = ((seq >> (DIGIT_BITS * (levels - 1 - l)))
               & (RADIX - 1)).to(torch.uint8)
        blocks[l] = _pack_level(dig, n, nblk)
        cnt = torch.bincount(dig, minlength=RADIX)
        Zc[l, 1:] = torch.cumsum(cnt, 0)[:RADIX - 1].to(torch.int32)
        if l + 1 < levels:
            seq = torch.cat([seq[dig == d] for d in range(RADIX)])
        del dig
    del seq
    C = torch.zeros(sigma + 1, dtype=torch.int64, device=dev)
    C[1:] = torch.cumsum(hist, 0)
    key = _digit_reversed(torch.arange(sigma, device=dev), levels)
    order = torch.argsort(key)
    start = torch.empty(sigma, dtype=torch.int64, device=dev)
    start[order] = torch.cumsum(hist[order], 0) - hist[order]
    return WaveletRows(blocks.contiguous(), Zc, start.to(torch.int32),
                       (C[:sigma] - start).to(torch.int32), C, n, sigma)


def build_wavelet_host(bwt: np.ndarray, sigma: int, device) -> WaveletRows:
    """``build_wavelet`` of a host BWT of dense symbols, on ``device``."""
    arr = np.asarray(bwt)
    if arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
    return build_wavelet(t.to(device), sigma)


def check_kernel_rows(wm: WaveletRows, dev, table: torch.Tensor) -> None:
    """Raise unless the rows are as the kernels read them: n < 2^31,
    contiguous int32 blocks on ``dev`` aligned to 64 bytes, the
    ``[levels, 8]`` table Zc and ``table`` (D or start) beside them."""
    for t in (wm.blocks, wm.Zc, table):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise TypeError("wavelet rows must be contiguous int32 tensors "
                            "on %s" % dev)
    if tuple(wm.Zc.shape) != (wm.levels, RADIX) \
            or wm.levels > MAX_LEVELS or wm.blocks.shape[2] != BLOCK_WORDS:
        raise ValueError("wavelet rows of at most %d levels of 16-word "
                         "blocks with a [levels, 8] digit table"
                         % MAX_LEVELS)
    if wm.n >= 1 << 31 or wm.blocks.data_ptr() % 64:
        raise ValueError("wavelet rows hold n < 2^31 in 64-byte aligned "
                         "blocks")


# ------------------------------------------------------------ plain queries

def _level(wm: WaveletRows, l: int, i: torch.Tensor,
           d: Optional[torch.Tensor] = None):
    """(rank_d(i), d) on level l for int64 positions i: the d digits of
    the level before i, d being the digit at i unless given."""
    blk = i // BLOCK_DIGITS
    off = i - blk * BLOCK_DIGITS
    row = wm.blocks[l][blk].long() & _U32                # [B, 16]
    counts = row[:, :COUNT_WORDS]
    # [B, word, plane]
    planes = row[:, COUNT_WORDS:].view(-1, DIGIT_BITS,
                                       PLANE_WORDS).transpose(1, 2)
    if d is None:
        word = planes.gather(1, (off >> 5)[:, None, None].expand(
            -1, 1, DIGIT_BITS)).squeeze(1)                # [B, plane]
        bits = (word >> (off & 31)[:, None]) & 1
        d = sum(bits[:, j] << j for j in range(DIGIT_BITS))
    before = torch.where(
        d < COUNT_WORDS,
        counts.gather(1, d.clamp(max=COUNT_WORDS - 1)[:, None]).squeeze(1),
        BLOCK_DIGITS * blk - counts.sum(1))
    keep = (off[:, None] - 32 * torch.arange(PLANE_WORDS,
                                             device=i.device)).clamp(0, 32)
    return before + digit_rank(planes, d[:, None], keep).sum(1), d


def _descend(wm: WaveletRows, i: torch.Tensor,
             c: Optional[torch.Tensor] = None):
    """(symbol, end position f) of the descent from positions i: along
    BWT[i]'s digits, or along the digits of the symbols ``c``."""
    i = i.long()
    sym = torch.zeros_like(i)
    Zc = wm.Zc.long()
    L = wm.levels
    for l in range(L):
        want = None if c is None else \
            (c >> (DIGIT_BITS * (L - 1 - l))) & (RADIX - 1)
        k, d = _level(wm, l, i, want)
        i = Zc[l][d] + k
        sym = (sym << DIGIT_BITS) | d
    return sym, i


def access(wm: WaveletRows, i: torch.Tensor) -> torch.Tensor:
    """BWT[i] (int64) for a batch of positions in [0, n)."""
    return _descend(wm, i)[0]


def rank(wm: WaveletRows, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[j] in BWT[0 : i[j]) for positions in [0, n]."""
    c = c.long()
    _sym, f = _descend(wm, i, c)
    return f - wm.start.long()[c]


def _level_all(wm: WaveletRows, l: int, i: torch.Tensor) -> torch.Tensor:
    """[M, 8] int64: rank_d(i) on level l for every digit d, from one
    block read per position."""
    blk = i // BLOCK_DIGITS
    off = i - blk * BLOCK_DIGITS
    row = wm.blocks[l][blk].long() & _U32                # [M, 16]
    counts = row[:, :COUNT_WORDS]
    planes = row[:, COUNT_WORDS:].view(-1, DIGIT_BITS,
                                       PLANE_WORDS).transpose(1, 2)
    keep = (off[:, None] - 32 * torch.arange(PLANE_WORDS,
                                             device=i.device)).clamp(0, 32)
    before = torch.cat([counts, (BLOCK_DIGITS * blk
                                 - counts.sum(1))[:, None]], 1)
    inblk = torch.stack([
        digit_rank(planes, torch.full_like(keep, d), keep).sum(1)
        for d in range(RADIX)], 1)
    return before + inblk


def rank_all(wm: WaveletRows, i: torch.Tensor,
             chunk: int = 1 << 22) -> torch.Tensor:
    """[B, sigma] int64: the occurrences of every symbol in BWT[0 : i[j]).

    A level walk, not a descent per symbol: the symbols that share their
    first l digits share the descent's position on level l, so each
    position of level l is read once and split eight ways (``_level_all``)
    into the positions of its children on level l + 1, ``Zc[l][d] +
    rank_d``; only the nodes that prefix a symbol below sigma go on.
    Where the walk ends, f - start[c] is c's rank, as in ``rank``.  A
    query position reads sum over l of ceil(sigma / 8^(levels - l))
    64-byte blocks, about sigma / 7 (9,363 at 65,536 symbols, 717 at
    5,000), where a descent per symbol reads sigma x levels (393,216 and
    25,000).  Positions go through in groups whose node positions on the
    last level stay within ``chunk``; the result is the caller's
    B x sigma x 8 bytes."""
    L, sigma = wm.levels, wm.sigma
    Zc = wm.Zc.long()
    start = wm.start.long()
    i = i.long()
    last = -(-sigma // RADIX)
    step = max(1, chunk // last)
    out = []
    for a in range(0, max(1, i.shape[0]), step):
        pos = i[a:a + step, None]                        # [b, nodes]
        for l in range(L):
            b, m = pos.shape
            nxt = Zc[l] + _level_all(wm, l, pos.reshape(-1))
            keep = -(-sigma // RADIX ** (L - 1 - l))
            pos = nxt.view(b, m * RADIX)[:, :keep]
        out.append(pos - start)
    return torch.cat(out) if len(out) > 1 else out[0]


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
