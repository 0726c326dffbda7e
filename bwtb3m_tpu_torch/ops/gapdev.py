"""Anchored gap computation of one pair merge — the scaled engine's chains.

Port of ``bwtb3m_tpu/ops/gapdev.py::DeviceGapRunner``.  For a merge of
the left block [s, m) into the right region M = [m, e), R(p) is the
number of rotations of M smaller than rotation p.  Walking p = m-1 down
to s, it follows the recurrence (reference: SURVEY.md section 3.1 phase
3, arXiv:1604.06687)

    R(p) = c_first[c] + rank_M(c, R(p+1)) - [isa_m < R(p+1) and c == text[m-1]]
           + [c == text[e-1] and rot(p+1) > rot(e)],       c = text[p]

and the gap histogram counts, for every right rank r, the left suffixes
with R(p) = r.  ``GapRunner`` splits [s, m) into T lanes, anchors each
lane's seed by the two-bound interval contraction (a short walk from R = 0
and from R = |M| that meets when the seed is determined), runs the chains
from those seeds, and keeps the histogram on the device, one int32 cell
per right rank (the reference's uint16 cells, wrap detection and int32
rerun are gone).  The wrap-term bits rot(p+1) > rot(e) come from the
native three-way rotation comparator on the host (``native.cmp_rot``),
as in the reference, for the positions whose symbol is text[e-1].

The walks are one CUDA kernel, ``csrc/gap_chain.cu::bwt_gap_chain``, in
two forms: ``chain_walk`` records every R into the histogram and the R of
sampled positions, ``anchor_walk`` keeps only the final rank.  Both
launch the kernel for CUDA tensors and use the plain PyTorch version
(``gap_chain_plain``) only for CPU tensors; any other device raises.
``_launch`` counts every launch in ``LAUNCHES`` per form.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .focc import kernel_row_width, rank

TEXT_BLOCK = 256
LAUNCHES = {"chain": 0, "anchor": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ host helpers

def cmp_rot(text: np.ndarray, e: int, xs: np.ndarray,
            nthreads: int = 4) -> np.ndarray:
    """sign(rot(x) - rot(e)) for each x in ``xs`` (int8), by the native
    comparator; a chunked numpy compare where the native library is not
    available (CPU runs only: a CUDA run requires the library,
    ``util/devices.py``), as the reference falls back to numpy."""
    n = len(text)
    xs = np.asarray(xs, np.int64)
    out = native.cmp_rot(text, n, e % n, xs, nthreads)
    if out is not None:
        return out[:len(xs)]
    out = np.zeros(len(xs), np.int8)
    ext = np.concatenate([text, text[:min(n, 256)]])
    for b in range(0, len(xs), 1 << 14):
        lanes = np.arange(b, min(len(xs), b + (1 << 14)))
        x, y = xs[lanes] % n, np.full(len(lanes), e % n)
        for _ in range(0, n, 256):
            if not len(lanes):
                break
            L = min(256, n)
            cx = ext[x[:, None] + np.arange(L)]
            cy = ext[y[:, None] + np.arange(L)]
            neq = cx != cy
            hit = neq.any(1)
            j = neq.argmax(1)[hit]
            k = np.flatnonzero(hit)
            out[lanes[k]] = np.where(cx[k, j] > cy[k, j], 1, -1)
            keep = ~hit
            lanes, x, y = lanes[keep], (x[keep] + L) % n, (y[keep] + L) % n
    return out


# ------------------------------------------------------------ plain version

def gap_chain_plain(focc, text: torch.Tensor, gt: torch.Tensor, lo0: int,
                    c_first: torch.Tensor, consts, starts: torch.Tensor,
                    seeds: torch.Tensor, lens: torch.Tensor,
                    gap: Optional[torch.Tensor] = None,
                    samp: Optional[torch.Tensor] = None, samp_p0: int = 0,
                    rate: int = 1) -> torch.Tensor:
    """Final rank (int64) of every lane; with ``gap`` also records every
    R into it and R(p) into ``samp[(p - samp_p0) // rate]`` where p is a
    multiple of ``rate``.  A Python loop over steps, vectorized over
    lanes."""
    k0, k1, k2 = (int(v) for v in consts)
    r, st, ln = seeds.long(), starts.long(), lens.long()
    cf = c_first.long()
    last = (ln - 1).clamp(min=0)
    steps = int(ln.max()) if len(ln) else 0
    for k in range(steps):
        act = k < ln
        p = st - torch.clamp(last, max=k)   # finished lanes stay in range
        c = text[p].long()
        off = p - lo0
        g = (gt[off >> 3].long() >> (off & 7)) & 1
        r_new = (cf[c] + rank(focc, c, r) - ((k0 < r) & (c == k1)).long()
                 + ((c == k2) & (g == 1)).long())
        r = torch.where(act, r_new, r)
        if gap is not None:
            ra = r[act]
            gap.index_add_(0, ra, torch.ones_like(ra, dtype=gap.dtype))
            hit = act & (p % rate == 0)
            samp[(p[hit] - samp_p0) // rate] = r[hit].to(samp.dtype)
    return r


# ------------------------------------------------------------ CUDA wrapper

def _lib():
    from ._build import load
    return load("gap_chain")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("no gap-chain kernel for device %s" % t.device)


def _check_args(focc, text, gt, lo0, c_first, starts, seeds, lens):
    dev = seeds.device
    for name, t, dt in (("text", text, torch.uint8), ("gt", gt, torch.uint8),
                        ("c_first", c_first, torch.int32),
                        ("starts", starts, torch.int64),
                        ("seeds", seeds, torch.int32),
                        ("lens", lens, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError("%s must be a contiguous %s tensor on %s"
                            % (name, dt, dev))
    if not (len(starts) == len(seeds) == len(lens)):
        raise ValueError("lane arrays are of one length")
    if text.shape[0] >= 1 << 32:
        raise ValueError("the gap-chain kernel keeps positions in uint32: "
                         "n < 2^32")
    if focc.rows.device != dev:
        raise TypeError("rank rows on %s, lanes on %s"
                        % (focc.rows.device, dev))
    kernel_row_width(focc)
    if len(seeds):
        # walked positions must lie inside the text and the gt bits, and
        # seeds inside the rank space: the kernel does not check
        lo = int((starts - lens + 1).min())
        hi = int(starts.max())
        if lo < lo0 or hi >= min(text.shape[0], lo0 + 8 * gt.shape[0]):
            raise ValueError("walk positions [%d, %d] outside the text or "
                             "the gt bits" % (lo, hi))
        if int(seeds.min()) < 0 or int(seeds.max()) > focc.n:
            raise ValueError("seeds outside [0, %d]" % focc.n)


def _launch(focc, text, gt, lo0, c_first, consts, starts, seeds, lens,
            gap=None, samp=None, samp_p0=0, rate=1) -> torch.Tensor:
    """The wrapper of ``bwt_gap_chain``: the recording form with ``gap``
    (and ``samp``), the anchor form without.  Returns the final ranks
    (int32) and counts the launch in ``LAUNCHES``."""
    _check_args(focc, text, gt, lo0, c_first, starts, seeds, lens)
    if gap is not None and (gap.dtype != torch.int32
                            or gap.shape[0] < focc.n + 1
                            or samp is None or samp.dtype != torch.int32
                            or rate < 1):
        raise TypeError("the recording form needs an int32 histogram of "
                        "n+1 cells, int32 samples and a rate >= 1")
    r_out = torch.empty_like(seeds)
    if len(seeds) == 0:
        return r_out
    lib = _lib()
    k0, k1, k2 = (int(v) for v in consts)
    rc = lib.bwt_gap_chain(
        _ptr(focc.rows), focc.rows.shape[1], _ptr(text), _ptr(gt), int(lo0),
        _ptr(c_first), k0, k1, k2, _ptr(starts), _ptr(seeds), _ptr(lens),
        _ptr(r_out), _ptr(gap), _ptr(samp), int(samp_p0), int(rate),
        len(seeds), ctypes.c_void_p(
            torch.cuda.current_stream(seeds.device).cuda_stream))
    LAUNCHES["chain" if gap is not None else "anchor"] += 1
    if rc != 0:
        raise RuntimeError("CUDA kernel launch failed: %s (%d)"
                           % (lib.bwt_error_string(rc).decode(), rc))
    return r_out


def chain_walk(focc, text, gt, lo0, c_first, consts, starts, seeds, lens,
               gap, samp, samp_p0: int, rate: int) -> torch.Tensor:
    """The recording walk: final ranks (int64); ``gap`` and ``samp`` are
    updated in place."""
    if not _on_cuda(seeds):
        return gap_chain_plain(focc, text, gt, lo0, c_first, consts, starts,
                               seeds, lens, gap, samp, samp_p0, rate)
    return _launch(focc, text, gt, lo0, c_first, consts, starts, seeds,
                   lens, gap, samp, samp_p0, rate).long()


def anchor_walk(focc, text, gt, lo0, c_first, consts, starts, seeds,
                lens) -> torch.Tensor:
    """The anchor walk: final ranks (int64) only."""
    if not _on_cuda(seeds):
        return gap_chain_plain(focc, text, gt, lo0, c_first, consts, starts,
                               seeds, lens)
    return _launch(focc, text, gt, lo0, c_first, consts, starts, seeds,
                   lens).long()


# ------------------------------------------------------------ the runner

class GapRunner:
    """Anchored gap computation for one pair merge of the left block
    [s, m) into the right region [m, e) whose rank rows are ``focc``.

    ``text_dev`` is the engine's dense text on the device (flat uint8),
    ``text_host`` the same text on the host for the gt comparator.
    ``anchor`` gives lane seeds, ``run_chains`` leaves the histogram in
    ``gap`` (int32 [gap_size + 1], on the device) and the final ranks in
    ``final_rs``; ``harvest_samples`` returns (position, R) at the
    multiples of ``sample_rate`` in [s, m)."""

    def __init__(self, focc, text_dev: torch.Tensor, text_host: np.ndarray,
                 s: int, m: int, e: int, isa_m: int, first_hist: np.ndarray,
                 sample_rate: int = 1, nthreads: int = 4, phase=None):
        self.focc = focc
        self.text_dev = text_dev
        self.text = text_host
        self.n = len(text_host)
        self.s, self.m, self.e = int(s), int(m), int(e)
        self.isa_m = int(isa_m)
        self.gap_size = self.e - self.m
        assert focc.n == self.gap_size
        if sample_rate < 1:
            raise ValueError("sample_rate must be >= 1")
        self.sample_rate = int(sample_rate)
        self.nthreads = nthreads
        self.phase = phase
        dev = text_dev.device
        # c_first[c] = number of M rotations starting with a symbol < c
        self.c_first = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(first_hist)[:-1]]).astype(np.int32)).to(dev)
        self.sym_before_m = int(text_host[(self.m - 1) % self.n])
        self.sym_last = int(text_host[(self.e - 1) % self.n])
        self.consts = (self.isa_m, self.sym_before_m, self.sym_last)
        self.lo0 = (self.s // TEXT_BLOCK) * TEXT_BLOCK
        self._gt_cap = 0
        self._gt = np.zeros(0, np.uint8)
        self.gt_dev = torch.zeros(0, dtype=torch.uint8, device=dev)
        self.gap = None
        self.final_rs = None
        self._samp = None
        self._samp_p0 = 0

    # ---------------------------------------------------------------- gt

    def ensure_gt(self, cap: int) -> None:
        """Ensure wrap-term bits cover walk positions [s, cap): bit
        p - lo0 is rot(p+1) > rot(e), for the positions with
        text[p] == text[e-1] (the only ones whose step reads it)."""
        cap = min(cap, self.e - 1)  # walks never consult x = p+1 beyond e-1
        if cap <= self._gt_cap:
            return
        with (self.phase("gt bits (host)") if self.phase
              else contextlib.nullcontext()):
            lo = max(self.s, self._gt_cap)
            ps = lo + np.flatnonzero(np.asarray(self.text[lo:cap])
                                     == self.sym_last).astype(np.int64)
            gt = (cmp_rot(self.text, self.e, ps + 1, self.nthreads) > 0
                  if len(ps) else np.zeros(0, bool))
            a = self.lo0 + ((lo - self.lo0) // 8) * 8   # byte-aligned start
            bits = np.zeros(cap - a, np.uint8)
            bits[ps - a] = gt
            chunk = np.packbits(bits, bitorder="little")
            packed = np.zeros((cap - self.lo0 + 7) // 8, np.uint8)
            packed[:len(self._gt)] = self._gt
            packed[(a - self.lo0) // 8:] |= chunk
            self._gt = packed
            self.gt_dev = torch.from_numpy(packed).to(self.text_dev.device)
            self._gt_cap = cap

    # ------------------------------------------------------------- walks

    def _lanes(self, starts, seeds, lens):
        dev = self.text_dev.device
        return (torch.from_numpy(np.asarray(starts, np.int64)).to(dev),
                torch.from_numpy(np.asarray(seeds, np.int32)).to(dev),
                torch.from_numpy(np.asarray(lens, np.int32)).to(dev))

    def anchor_bound(self, starts: np.ndarray, lbs: np.ndarray,
                     r0_val: int) -> np.ndarray:
        """One contraction pass: lane j walks positions starts[j] + lbs[j]
        down to starts[j] + 1 from the seed r0_val; returns the final
        ranks."""
        walk_start = starts + lbs
        self.ensure_gt(int(walk_start.max()) + 1)
        st, sd, ln = self._lanes(walk_start,
                                 np.full(len(starts), r0_val), lbs)
        return anchor_walk(self.focc, self.text_dev, self.gt_dev, self.lo0,
                           self.c_first, self.consts, st, sd,
                           ln).cpu().numpy().astype(np.int64)

    def anchor(self, starts: np.ndarray, lookback: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """R(start_j + 1) by interval contraction over up to ``lookback``
        steps; per-lane lookback clamps keep positions <= e-2.  Returns
        (ranks, resolved mask)."""
        lbs = np.minimum(lookback, (self.e - 2) - starts)
        lbs = np.maximum(lbs, 1)
        lo = self.anchor_bound(starts, lbs, 0)
        hi = self.anchor_bound(starts, lbs, self.gap_size)
        return lo, lo == hi

    def run_chains(self, starts: np.ndarray, seeds: np.ndarray,
                   lens: np.ndarray) -> None:
        """Walk lane j from position starts[j] (seeded with
        R(starts[j]+1) = seeds[j]) for lens[j] steps, recording every new
        R into the histogram and R at the sampled positions."""
        assert self.gap_size + 2 <= ((1 << 24) - 1) * 256, \
            "rank space must stay 256 short of 2^32"
        self.ensure_gt(int(starts.max()) + 1)
        dev = self.text_dev.device
        rate = self.sample_rate
        self._samp_p0 = self.s + (-self.s) % rate
        nsamp = len(range(self._samp_p0, self.m, rate))
        self.gap = torch.zeros(self.gap_size + 1, dtype=torch.int32,
                               device=dev)
        self._samp = torch.full((nsamp,), -1, dtype=torch.int32, device=dev)
        st, sd, ln = self._lanes(starts, seeds, lens)
        final = chain_walk(self.focc, self.text_dev, self.gt_dev, self.lo0,
                           self.c_first, self.consts, st, sd, ln, self.gap,
                           self._samp, self._samp_p0, rate)
        self.final_rs = final.cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------ results

    def gap_checksum(self) -> int:
        return int(self.gap.sum())

    def harvest_samples(self) -> Tuple[np.ndarray, np.ndarray]:
        """(positions, R values) at sample_rate-aligned walked positions,
        ascending."""
        vals = self._samp.cpu().numpy().astype(np.int64)
        pos = self._samp_p0 + self.sample_rate * np.arange(len(vals),
                                                           dtype=np.int64)
        seen = vals >= 0
        return pos[seen], vals[seen]


def runner_inputs_from_jax(jax_runner) -> dict:
    """The inputs a reference ``DeviceGapRunner`` computed for its walks,
    as numpy: ``c_first``, ``consts`` (isa_m, sym_before_m, sym_last),
    the gt bytes (bit p - lo0 for walk position p, LSB first; trailing
    shape padding included) and ``lo0``."""
    gt = jax_runner._gt_packed
    return {
        "c_first": np.asarray(jax_runner.c_first).astype(np.int64),
        "consts": np.asarray(jax_runner.consts).astype(np.int64),
        "gt": (np.zeros(0, np.uint8) if gt is None
               else np.asarray(gt, np.uint8).reshape(-1)),
        "lo0": int(jax_runner.lo0),
    }
