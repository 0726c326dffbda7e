"""Succinct PLCP (permuted LCP) construction: the ``lcpbit`` tool's core.

Port of ``bwtb3m_tpu/lcp/plcp.py``.  ``compute_plcp`` routes a text as
the reference does:

    n <= 2^22 (or sigma > 256 after rank compaction fails): prefix
        doubling that keeps every round's ranks, then a fixed descent
        over the levels (``_doubling_with_levels``, ``_plcp_descent``);
    n * 18 (19 for byte windows) bytes within the device budget: the
        device route, the doubling's SA kept on the device, Phi by
        scatter, one launch of the Kasai walk (``compute_plcp_device``);
    otherwise the slab route: Phi and PLCP travel per slab of positions
        while the text words stay on the device (``compute_plcp_scaled``).

The walk reads no ISA: the reference tests ISA[p] != 0 only, which
fails at p0 = SA[0] alone, and the walk takes p0.

Both Kasai routes run the word-window walk of ``ops/kasai.py``, the CUDA
kernel ``bwt_kasai_plcp`` on a card, in one launch per slab.  The
budget is what ``util/devices.py::device_budget`` reads off the device,
unless ``BWTB3M_PLCP_DEV_BYTES`` sets it.  Texts of 2^31 symbols or more
raise ``ValueError`` on every route, as the doubling sort does.

Succinct encoding (the classic 2n-bit PLCP): the bit stream
``0^{d_0} 1 0^{d_1} 1 ...`` with d_0 = PLCP[0] and d_p = PLCP[p] -
PLCP[p-1] + 1, so PLCP[p] = select1(p) - 2p.  The file format is "PLB1"
(FORMATS.md): magic, n, nbits, u64 words (LSB-first).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops.doubling import (_initial_key, _pack_width, _rerank,
                            suffix_array, suffix_sa_bwt)
from ..ops.focc import from_u32_bits
from ..ops.kasai import kasai_walk
from ..util import serial
from ..util.devices import device_budget, resolve_device

MAGIC = b"PLB1"
SMALL_N = 1 << 22      # at most this many symbols: the level descent
# lanes of the Kasai walk.  A lane keeps its Phi and PLCP sectors and its
# windows' words in registers, so lanes hold no lines in the L2 and more
# of them hide the latency of the one random read a step makes: at 1.2 G
# symbols 2^17 lanes (the reference's count) walk fastest of 2^15-2^18
# (chip_smoke.py's lane sweep, PERF.md)
LANES = 1 << 17


# --------------------------------------------------------------------------
# doubling with retained levels (small texts)
# --------------------------------------------------------------------------

def _doubling_with_levels(sym: torch.Tensor, sigma: int, n_levels: int):
    """Prefix doubling of the circular text ``sym`` (int64) that keeps the
    int32 rank array of every level: level j orders the rotations by
    their first w * 2^j symbols.  Returns (levels [n_levels, n], sa)."""
    n = sym.shape[0]
    w = _pack_width(sigma)
    k_s, sa = torch.sort(_initial_key(sym, sigma, w), stable=True)
    rank = torch.empty_like(sa)
    rank[sa] = _rerank(k_s)
    levels = [rank.to(torch.int32)]
    k = w
    for _lev in range(1, n_levels):
        k_s, sa = torch.sort((rank << 32) | torch.roll(rank, -k), stable=True)
        rank = torch.empty_like(sa)
        rank[sa] = _rerank(k_s)
        levels.append(rank.to(torch.int32))
        k = min(k * 2, n)
    return torch.stack(levels), sa


def _plcp_descent(sym: torch.Tensor, levels: torch.Tensor, sa: torch.Tensor,
                  sigma: int, n_levels: int) -> torch.Tensor:
    """PLCP of every position at once: from the top level down, add the
    level's span to l where the ranks at p + l and Phi(p) + l agree, then
    fewer than w single-symbol compares; the smallest rotation gets 0."""
    n = sym.shape[0]
    w = _pack_width(sigma)
    pos = torch.arange(n, device=sym.device)
    isa = torch.empty_like(sa)
    isa[sa] = pos
    q = sa[torch.where(isa == 0, n - 1, isa - 1)]
    l = torch.zeros_like(pos)
    for j in range(n_levels - 1, -1, -1):
        span = min(w << j, n)
        lev = levels[j]
        ok = (lev[(pos + l) % n] == lev[(q + l) % n]) & (l + span <= n)
        l = torch.where(ok, l + span, l)
    alive = l < n
    for _t in range(w):
        step = alive & (sym[(pos + l) % n] == sym[(q + l) % n]) & (l < n)
        l = torch.where(step, l + 1, l)
        alive = step
    l[sa[0]] = 0
    return l


# --------------------------------------------------------------------------
# the Kasai routes
# --------------------------------------------------------------------------

def _pack_text_words(text: np.ndarray, sigma: int, device) -> torch.Tensor:
    """The text as uint32 words of LSB-first symbols (8 nibbles a word for
    sigma <= 16, 4 bytes up to 256) and one pad word, built on
    ``device``: an int32 tensor of the reference's words' bits."""
    t = torch.from_numpy(np.require(text, np.uint8, "CW")).to(device)
    spw = 8 if sigma <= 16 else 4
    pad = (-t.shape[0]) % spw
    if pad:
        t = torch.cat([t, t.new_zeros(pad)])
    if sigma <= 16:
        t = t[0::2] | (t[1::2] << 4)
    return torch.cat([t.view(torch.int32), t.new_zeros(4).view(torch.int32)])


def _lane_bounds(a: int, b: int, lanes: int, device):
    """(p, pend) of min(lanes, b - a) lanes over [a, b), as the
    reference's ``np.linspace`` cuts them."""
    bounds = np.linspace(a, b, min(lanes, b - a) + 1).astype(np.int64)
    bounds = torch.from_numpy(bounds).to(device)
    return bounds[:-1], bounds[1:]


def device_walk_arrays(text: np.ndarray, sigma: int, sa: torch.Tensor):
    """The Kasai walk's arguments on the device of ``sa`` (int64, the
    whole suffix array): (words, phi, p0, bits), Phi scattered from the
    SA as int32 (Phi of the rank-0 position is 0, never read) and p0 =
    SA[0]."""
    n, device = sa.shape[0], sa.device
    words = _pack_text_words(text, sigma, device)
    phi = torch.zeros(n, dtype=torch.int32, device=device)
    phi[sa[1:]] = sa[:-1].to(torch.int32)
    return words, phi, int(sa[0]), 4 if sigma <= 16 else 8


def compute_plcp_device(text: np.ndarray, sigma: int, sa_dev: torch.Tensor,
                        lanes: int = LANES, device="cuda") -> torch.Tensor:
    """PLCP of a text whose SA, Phi and PLCP fit the device: ``sa_dev``
    is the suffix array on the device (``engine.ssa.compute_sa_device``
    or the doubling's), Phi is scattered from it, and one launch of the
    Kasai walk runs every lane to its end.  Any sigma <= 256 (byte
    windows above 16).  Returns PLCP as an int32 tensor [n] on
    ``device``."""
    device = resolve_device(device)
    n = len(text)
    if sigma > 256 or n >= 1 << 31:
        raise ValueError("the device PLCP route takes sigma <= 256 and "
                         "n < 2^31")
    sa = sa_dev.to(device, torch.int64)
    if sa.shape != (n,):
        raise ValueError("the SA holds %d positions, the text %d"
                         % (sa.shape[0], n))
    words, phi, p0, bits = device_walk_arrays(text, sigma, sa)
    plcp = torch.zeros(n, dtype=torch.int32, device=device)
    p, pend = _lane_bounds(0, n, lanes, device)
    kasai_walk(words, phi, p0, plcp, p, torch.zeros_like(p), pend, n, 0,
               bits)
    return plcp


def encode_plcp_bits_device(plcp_dev: torch.Tensor) -> Tuple[int, np.ndarray]:
    """The succinct 2n-bit encoding on the device: bit PLCP[p] + 2p is
    set, and only the packed bytes come to the host.  The positions rise
    strictly, so each 32-bit word is the sum of its bits.  Returns
    (nbits, bytes LSB-first)."""
    n = int(plcp_dev.shape[0])
    if n == 0:
        return 0, np.zeros(0, np.uint8)
    nbits = int(from_u32_bits(plcp_dev[n - 1])) + 2 * (n - 1) + 1
    words = torch.zeros((nbits + 31) // 32, dtype=torch.int64,
                        device=plcp_dev.device)
    chunk = 1 << 26
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        pos = from_u32_bits(plcp_dev[s:e]) + 2 * torch.arange(
            s, e, dtype=torch.int64, device=plcp_dev.device)
        words.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    by = words.view(torch.uint8).view(-1, 8)[:, :4].reshape(-1)
    return nbits, by[:(nbits + 7) // 8].cpu().numpy()


def write_plcp_bytes(path: str, n: int, nbits: int, by: np.ndarray) -> None:
    """PLB1 writer from pre-packed bits (the device encoder's output)."""
    pad = (-len(by)) % 8
    if pad:
        by = np.concatenate([by, np.zeros(pad, np.uint8)])
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u64(f, n)
        serial.write_u64(f, nbits)
        serial.write_u64_array(f, np.asarray(by.view("<u8"), np.uint64))


def compute_plcp_scaled(text: np.ndarray, sigma: Optional[int] = None,
                        lanes: int = LANES, sa_isa=None,
                        slab_positions: int = 1 << 28, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """PLCP with O(slab) device memory: the text words stay on the device,
    Phi and PLCP travel per slab of ``slab_positions`` positions, one
    launch of the Kasai walk each.  ``sa_isa`` supplies a precomputed
    (sa, isa) pair, as the reference's does (only its SA is read), which
    skips the doubling sort and lets the walk take texts up to 2^32
    symbols.  Any sigma <= 256.  Returns (plcp int64
    [n], sa int64 [n])."""
    device = resolve_device(device)
    text = np.asarray(text)
    n = len(text)
    if sigma is None:
        sigma = int(text.max()) + 1 if n else 1
    if n <= 1:
        return np.zeros(n, np.int64), np.zeros(n, np.int64)
    if sigma > 256:
        raise ValueError("scaled PLCP supports sigma <= 256; rank-compact "
                         "the alphabet first (compute_plcp does)")
    if n >= 1 << 32:
        raise ValueError("the slab walk takes n < 2^32")
    if sa_isa is not None:
        sa = np.asarray(sa_isa[0])
    else:
        sa = suffix_array(text, sigma, device)[0]
    phi = np.zeros(n, np.uint32)
    phi[sa[1:]] = sa[:-1]        # rank 0 is committed as 0 by the walk
    bits = 4 if sigma <= 16 else 8
    words = _pack_text_words(text, sigma, device)
    plcp_host = np.zeros(n, np.int64)
    slab = min(slab_positions, n)
    for a in range(0, n, slab):
        b = min(n, a + slab)
        p, pend = _lane_bounds(a, b, lanes, device)
        phi_d = torch.from_numpy(phi[a:b].view(np.int32)).to(device)
        plcp_d = torch.zeros(b - a, dtype=torch.int32, device=device)
        kasai_walk(words, phi_d, int(sa[0]), plcp_d, p, torch.zeros_like(p),
                   pend, n, a, bits)
        plcp_host[a:b] = from_u32_bits(plcp_d).cpu().numpy()
    return plcp_host, np.asarray(sa, np.int64)


def compute_plcp(text: np.ndarray, sigma: Optional[int] = None,
                 device="cuda", log=None) -> Tuple[np.ndarray, np.ndarray]:
    """(plcp int64 [n], sa int64 [n]) of the circular text, on the route
    its size asks for (module docstring); ``log`` (a ``VerboseLog``) gets
    the route and its times."""
    device = resolve_device(device)
    text = np.asarray(text)
    n = len(text)
    if n >= 1 << 31:
        raise ValueError("PLCP construction supports n < 2^31 (the doubling "
                         "sort's int32 rank space)")
    text = text.astype(np.int32, copy=False)
    if sigma is None:
        sigma = int(text.max()) + 1 if n else 1
    if n <= 1:
        return np.zeros(n, np.int64), np.zeros(n, np.int64)
    if sigma > 256:
        # a strictly monotonic remap keeps the rotation order (so the SA)
        # and symbol equality (so every LCP value)
        uniq = np.unique(text)
        if len(uniq) <= 256:
            text = np.searchsorted(uniq, text).astype(np.int32)
            sigma = len(uniq)
    t0 = time.monotonic()
    if n > SMALL_N and sigma <= 256:
        budget = int(os.environ.get("BWTB3M_PLCP_DEV_BYTES", 0)) \
            or device_budget(device)
        # 18 bytes a symbol with nibble windows (sigma <= 16), 19 with
        # byte windows
        if n * (18 if sigma <= 16 else 19) <= budget:
            sym = torch.from_numpy(text).to(device).long()
            sa_dev, _bwt = suffix_sa_bwt(sym, sigma)
            del sym, _bwt
            t1 = time.monotonic()
            plcp = compute_plcp_device(text, sigma, sa_dev, device=device)
            # n < 2^31: the int32 values are the PLCP values
            out = plcp.cpu().numpy().astype(np.int64), sa_dev.cpu().numpy()
            if log is not None:
                log.v("plcp: device route, n=%d, sort %.3f s, Kasai walk and "
                      "downloads %.3f s (%s)" % (n, t1 - t0,
                                                 time.monotonic() - t1,
                                                 device))
            return out
        out = compute_plcp_scaled(text, sigma, device=device)
        if log is not None:
            log.v("plcp: slab route, n=%d, %.3f s (%s)"
                  % (n, time.monotonic() - t0, device))
        return out
    w = _pack_width(sigma)
    n_levels = 1
    while w * (1 << (n_levels - 1)) < n:
        n_levels += 1
    sym = torch.from_numpy(text).to(device).long()
    levels, sa = _doubling_with_levels(sym, int(sigma), n_levels)
    plcp = _plcp_descent(sym, levels, sa, int(sigma), n_levels)
    if log is not None:
        log.v("plcp: level descent, n=%d, %d levels, %.3f s (%s)"
              % (n, n_levels, time.monotonic() - t0, device))
    return plcp.cpu().numpy(), sa.cpu().numpy()


# --------------------------------------------------------------------------
# succinct encoding
# --------------------------------------------------------------------------

def encode_plcp_bits(plcp: np.ndarray) -> np.ndarray:
    """PLCP -> unary delta bit array (uint8 0/1)."""
    plcp = np.asarray(plcp, dtype=np.int64)
    n = len(plcp)
    if n == 0:
        return np.zeros(0, np.uint8)
    deltas = np.empty(n, dtype=np.int64)
    deltas[0] = plcp[0]
    deltas[1:] = plcp[1:] - plcp[:-1] + 1
    if (deltas < 0).any():
        raise ValueError("PLCP violates PLCP[p + 1] >= PLCP[p] - 1")
    total = int(deltas.sum()) + n
    bits = np.zeros(total, dtype=np.uint8)
    bits[np.cumsum(deltas + 1) - 1] = 1
    return bits


def decode_plcp_bits(bits: np.ndarray, n: int) -> np.ndarray:
    ones = np.flatnonzero(np.asarray(bits))
    if len(ones) != n:
        raise ValueError("expected %d ones, found %d" % (n, len(ones)))
    return ones - 2 * np.arange(n, dtype=np.int64)


class PLCPBitDecoder:
    """Reader of ``.lcpbit`` files (the reference's ``lcp::PLCPBitDecoder``)."""

    def __init__(self, path: str, n: Optional[int] = None):
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not a PLB1 file: %s" % path)
            self.n = serial.read_u64(f)
            nbits = serial.read_u64(f)
            words = serial.read_u64_array(f, (nbits + 63) // 64)
        if n is not None and n != self.n:
            raise ValueError("length mismatch: file n=%d, expected %d"
                             % (self.n, n))
        bits = np.unpackbits(words.astype("<u8").view(np.uint8),
                             bitorder="little")[:nbits]
        self._plcp = decode_plcp_bits(bits, self.n)

    def get(self, p):
        return self._plcp[np.asarray(p, dtype=np.int64)]

    def all(self) -> np.ndarray:
        return self._plcp.copy()


def write_plcp_file(path: str, plcp: np.ndarray) -> None:
    bits = encode_plcp_bits(plcp)
    nbits = len(bits)
    padded = np.zeros(((nbits + 63) // 64) * 64, dtype=np.uint8)
    padded[:nbits] = bits
    words = np.packbits(padded, bitorder="little").view(np.uint64)
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u64(f, len(plcp))
        serial.write_u64(f, nbits)
        serial.write_u64_array(f, words)


# --------------------------------------------------------------------------
# file-level entry points
# --------------------------------------------------------------------------

def _text_from_bwt_meta(bwt_path: str) -> Tuple[np.ndarray, int]:
    """(text, sigma) of the input that the build of ``bwt_path`` names in
    its ``.meta``."""
    from ..engine.result import BwtResult
    from ..io.inputtypes import parse_input_type

    result = BwtResult.load(bwt_path)
    itype = parse_input_type(result.meta["inputtype"])
    return itype.load(result.meta["input"])


def compute_plcp_file(bwt_path: str, out_path: str, device="cuda",
                      log=None) -> str:
    """lcpbit: the text (through the ``.meta``) -> ``.lcpbit``."""
    text, sigma = _text_from_bwt_meta(bwt_path)
    plcp, _sa = compute_plcp(text, sigma, device=device, log=log)
    write_plcp_file(out_path, plcp)
    return out_path


def kasai_plcp(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """The independent host oracle: Phi and direct circular compares
    (checkLCPBit's recompute-and-compare); native first."""
    text = np.asarray(text)
    n = len(text)
    nat = native.kasai_plcp(text, np.asarray(sa))
    if nat is not None:
        return nat
    isa = np.zeros(n, dtype=np.int64)
    isa[sa] = np.arange(n)
    plcp = np.zeros(n, dtype=np.int64)
    l = 0
    for p in range(n):
        r = isa[p]
        if r == 0:
            l = 0
            continue
        q = sa[r - 1]
        while l < n and text[(p + l) % n] == text[(q + l) % n]:
            l += 1
        plcp[p] = l
        l = max(0, l - 1)
    return plcp


def verify_plcp_file(lcpbit_path: str, bwt_path: str, device="cuda") -> bool:
    """checkLCPBit: the ``.lcpbit`` against PLCP recomputed by the host
    oracle over the doubling sort's SA (on ``device``)."""
    text, sigma = _text_from_bwt_meta(bwt_path)
    sa, _isa, _bwt = suffix_array(text, sigma, resolve_device(device))
    return verify_plcp(lcpbit_path, text, sa)


def verify_plcp(lcpbit_path: str, text: np.ndarray, sa: np.ndarray) -> bool:
    dec = PLCPBitDecoder(lcpbit_path, n=len(text))
    return bool(np.array_equal(dec.all(), kasai_plcp(text, sa)))
