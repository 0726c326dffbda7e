"""The anchored gap computation of the merge engine: every pair merge of
one level of the merge tree as one lane population.

Port of ``bwtb3m_tpu/ops/gapbatch.py`` and, as the level of one merge,
of ``bwtb3m_tpu/ops/gapdev.py::DeviceGapRunner``: there is one runner and
one kernel entry, and a single pair merge (a level with one pair, a
resumed build, ``batchmerges=0``, a level past the device budget) is a
batch of one.  A level of a genome-sized build has many pair merges (12
on the first level of a 3.2 Gbp text at 2^27 symbols per block), and each
would pay its own anchor rounds, chain launch, rank-row build and
histogram when run alone.  Here the K merges of a level share them:

- the K right regions' rank rows are concatenated
  (``ops/focc_build.py::build_focc_concat``): every region starts on a
  row boundary and keeps its trailing checkpoint row, and its occ counts
  are region-local, so a lane of merge k queries its region with the
  global rank ``rbase_k + local`` through the unchanged row code;
- the per-merge constants (``c_first`` and ``isa_m`` already offset by
  ``rbase_k``, the two boundary symbols, the merge's gt bit base and its
  sample base) are one table of K rows that a lane of the kernel reads
  once; ranks stay global across steps;
- one histogram of uint32 cells (held as int32) spans the level's rank
  space (the kept checkpoint rows keep the regions' cells apart), the
  wrap-term bits of all merges are one byte array, and the sampled ranks
  of all merges one tensor.

``BatchedGapRunner`` splits each left block into lanes, anchors each
lane's seed by the two-bound interval contraction (a short walk from the
region's rank 0 and from its top that meets when the seed is determined;
the lane boundaries of all merges contract in one population, and the
lookback grows jointly), runs the chains from those seeds and checks
every lane's final rank against the seed of the lane to its left.

The walks are the CUDA entry ``csrc/gap_chain.cu::bwt_gap_chain_mk`` in
the recording and the anchor form; ``chain_walk_mk`` / ``anchor_walk_mk``
launch it for CUDA tensors and use ``gap_chain_mk_plain`` only for CPU
tensors; any other device raises.  ``_launch`` counts every launch in
``LAUNCHES`` per form.  What the reference needed for the TPU is gone:
the ``[rows, 256]`` uint16 histogram with its wrap rerun, the compressed
fetch, the 256-column phase alignment of all lanes, the ``[lanes,
sigma]`` constant tables and the lane padding.

Under a mesh of ranks (``parallel/mesh.py``) each rank walks a
contiguous part of the lanes, and the parts' results meet in one
collective each (``BatchedGapRunner``); ``parallel/shocc.py`` puts its
rank-range-sharded walks in the runner's place.

A wide merge (its rank space or left block reaches 2^32, its positions
pass 2^32, or ``BWTB3M_FORCE_WIDE``) is a runner of one merge with
``wide=True``, the port of ``bwtb3m_tpu/ops/gapwide.py::
WideDeviceGapRunner``: its rank rows are ``ops/wideocc.py``'s wide rows,
its ranks, constants, samples and histogram cells are int64, and the
walks take the kernel's 64-bit form, ``bwt_gap_chain_mk_w``.  The
reference never batches a wide level, and neither does the engine.

Past 256 distinct symbols (``bits=16``, or ``bits=32`` past 65,536) the
runner holds one merge too: its right region's rank rows are the
wavelet rows of ``ops/wavelet_rows.py``, the text is the dense ids
(``wavelet_rows.symbol_dtype``: the int16 of uint16 ids, int32 past
65,536 symbols, up to 2^21), and the walks take the entry
``bwt_gap_chain_mk_wm`` (narrow words; its uint16 or uint32 form), in
place of the reference's legacy ``ops/gap.py::_chain_steps`` and
``_anchor_steps``.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..util import trace
from . import wavelet_rows as wr
from .focc import as_u32_bits, from_u32_bits, kernel_row_width, rank
from .focc_build import build_focc_concat, build_focc_from_packed
from .gapdev import TEXT_BLOCK, wrap_bits
from .pack import unpack_bits
from .wavelet_rows import WaveletRows, symbol_values
from .wideocc import WideOcc, kernel_tables, rank_w

_U32 = 0xFFFFFFFF
# uint32 words of one merge's row of the constant table, in the order of
# ``csrc/gap_chain.cu``'s ``Merge``
MERGE_WORDS = 8
(M_CFIRST, M_K0, M_K1, M_K2, M_LO0, M_GTBASE, M_SAMPBASE,
 M_SAMPP0) = range(MERGE_WORDS)
# launches per form ("64": the 64-bit form, bwt_gap_chain_mk_w; "_wm":
# bwt_gap_chain_mk_wm over wavelet rows with uint16 symbols, "_wm32" with
# uint32 symbols)
LAUNCHES = {"chain": 0, "anchor": 0, "chain64": 0, "anchor64": 0,
            "chain_wm": 0, "anchor_wm": 0, "chain_wm32": 0, "anchor_wm32": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def u32_bits(a) -> np.ndarray:
    """Values in [0, 2^32) (taken modulo 2^32) as the int32 of the same
    bits: torch has no uint32 arithmetic, so uint32 words travel so."""
    return (np.asarray(a, np.int64) & _U32).astype(np.uint32).view(np.int32)


def word_values(focc, t: torch.Tensor) -> torch.Tensor:
    """The int64 values of a tensor of the chain's words: int32 of uint32
    bits on narrow rows, int64 already on wide rows."""
    return t.long() if isinstance(focc, WideOcc) else from_u32_bits(t)


# ------------------------------------------------------------ plain version

def gap_chain_mk_plain(focc, text: torch.Tensor, gt: torch.Tensor,
                       c_first: torch.Tensor, table: torch.Tensor,
                       kid: torch.Tensor, starts: torch.Tensor,
                       seeds: torch.Tensor, lens: torch.Tensor,
                       gap: Optional[torch.Tensor] = None,
                       samp: Optional[torch.Tensor] = None,
                       rate: int = 1, rank_fn=None,
                       gap_base: Optional[int] = None) -> torch.Tensor:
    """Final global rank (int64) of every lane; with ``gap`` also records
    every R into it and R(p) into the lane's merge's samples where p is a
    multiple of ``rate``.  Arithmetic is modulo 2^32 on narrow rows (the
    uint32 words travel as int32 bits), as in the kernel; on wide rows
    (``ops/wideocc.py``) every word is int64.  A Python loop over steps,
    vectorized over lanes.

    ``rank_fn(c, r)``, when given, answers the rank queries in place of
    the rows' own ``rank``; with ``gap_base`` the histogram ``gap`` holds
    only the cells [gap_base, gap_base + len(gap)) and the others are not
    recorded (``parallel/shocc.py``: rows and histogram sharded by rank
    range)."""
    wide = isinstance(focc, WideOcc)
    mask = -1 if wide else _U32                   # x & -1 == x
    rank_of = (rank_w if wide else wr.rank if isinstance(focc, WaveletRows)
               else rank)
    if rank_fn is not None:
        def rank_of(_focc, c, r):
            return rank_fn(c, r)
    m = word_values(focc, table)[kid.long()]      # [T, MERGE_WORDS]
    cf = word_values(focc, c_first)
    r, st, ln = word_values(focc, seeds), starts.long(), lens.long()
    last = (ln - 1).clamp(min=0)
    steps = int(ln.max()) if len(ln) else 0
    for k in range(steps):
        act = k < ln
        p = st - torch.clamp(last, max=k)   # finished lanes stay in range
        c = symbol_values(text[p])
        off = p - m[:, M_LO0]
        g = (gt[m[:, M_GTBASE] + (off >> 3)].long() >> (off & 7)) & 1
        r_new = (cf[m[:, M_CFIRST] + c] + rank_of(focc, c, r)
                 - ((m[:, M_K0] < r) & (c == m[:, M_K1])).long()
                 + ((c == m[:, M_K2]) & (g == 1)).long()) & mask
        r = torch.where(act, r_new, r)
        if gap is not None:
            ra = r[act]
            if gap_base is not None:
                ra = ra - gap_base
                ra = ra[(ra >= 0) & (ra < len(gap))]
            gap.index_add_(0, ra, torch.ones_like(ra, dtype=gap.dtype))
            hit = act & (p % rate == 0)
            slot = m[:, M_SAMPBASE] + (p - m[:, M_SAMPP0]) // rate
            bits = r if wide else torch.where(r >= 1 << 31, r - (1 << 32), r)
            samp[slot[hit]] = bits[hit].to(samp.dtype)
    return r


# ------------------------------------------------------------ CUDA wrapper

def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("no gap-chain kernel for device %s" % t.device)


def _check_args(focc, text, gt, c_first, table, kid, starts, seeds, lens):
    dev = seeds.device
    wide = isinstance(focc, WideOcc)
    wavelet = isinstance(focc, WaveletRows)
    word = torch.int64 if wide else torch.int32
    for name, t, dt in (("text", text,
                         wr.symbol_dtype(focc.sigma) if wavelet
                         else torch.uint8),
                        ("gt", gt, torch.uint8),
                        ("c_first", c_first, word), ("table", table, word),
                        ("kid", kid, torch.int32),
                        ("starts", starts, torch.int64),
                        ("seeds", seeds, word),
                        ("lens", lens, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError("%s must be a contiguous %s tensor on %s"
                            % (name, dt, dev))
    if not (len(kid) == len(starts) == len(seeds) == len(lens)):
        raise ValueError("lane arrays are of one length")
    if table.dim() != 2 or table.shape[1] != MERGE_WORDS:
        raise ValueError("the merge table has %d words per merge"
                         % MERGE_WORDS)
    if not wide and focc.n >= 1 << 32:
        raise ValueError("the narrow gap chain keeps ranks in uint32: the "
                         "level's rank space < 2^32")
    if wavelet:
        if table.shape[0] != 1:
            raise ValueError("the chain over wavelet rows holds one merge")
        wr.check_kernel_rows(focc, dev, focc.start)
    else:
        if focc.rows.device != dev:
            raise TypeError("rank rows on %s, lanes on %s"
                            % (focc.rows.device, dev))
        kernel_row_width(focc.focc if wide else focc)
    if len(seeds):
        # walked positions must lie inside the text and the merge's gt
        # bits, c_first words inside their table, seeds inside the rank
        # space: the kernel does not check
        if int(kid.min()) < 0 or int(kid.max()) >= table.shape[0]:
            raise ValueError("lane merge ids outside the table")
        m = word_values(focc, table)[kid.long()]
        lo = starts - lens + 1
        if bool((lo < m[:, M_LO0]).any()) \
                or int(starts.max()) >= text.shape[0] \
                or int((m[:, M_GTBASE]
                        + ((starts - m[:, M_LO0]) >> 3)).max()) \
                >= gt.shape[0]:
            raise ValueError("walk positions outside the text or the gt "
                             "bits")
        if not wide and int(starts.max()) >= 1 << 32:
            raise ValueError("the narrow gap chain keeps positions in "
                             "uint32: below 2^32")
        if int(m[:, M_CFIRST].max()) + focc.sigma > c_first.shape[0]:
            raise ValueError("c_first holds sigma words per merge")
        sd = word_values(focc, seeds)
        if int(sd.min()) < 0 or int(sd.max()) > focc.n:
            raise ValueError("seeds outside [0, %d]" % focc.n)


def _launch(focc, text, gt, c_first, table, kid, starts, seeds, lens,
            gap=None, samp=None, rate=1) -> torch.Tensor:
    """The wrapper of ``bwt_gap_chain_mk`` and, on wide rows, of its
    64-bit form ``bwt_gap_chain_mk_w``: the recording form with ``gap``
    (and ``samp``), the anchor form without.  Returns the final ranks
    (int32 holding uint32 bits; int64 on wide rows) and counts the
    launch in ``LAUNCHES``."""
    _check_args(focc, text, gt, c_first, table, kid, starts, seeds, lens)
    wide = isinstance(focc, WideOcc)
    word = torch.int64 if wide else torch.int32
    if gap is not None and (gap.dtype != word or gap.shape[0] < focc.n + 1
                            or samp is None or samp.dtype != word
                            or rate < 1):
        raise TypeError("the recording form needs a %s histogram of one "
                        "cell per rank, %s samples and a rate >= 1"
                        % (word, word))
    r_out = torch.empty_like(seeds)
    if len(seeds) == 0:
        return r_out
    from ._build import load
    lib = load("gap_chain")
    stream = ctypes.c_void_p(
        torch.cuda.current_stream(seeds.device).cuda_stream)
    lanes = (_ptr(text), _ptr(gt), _ptr(c_first), _ptr(table), _ptr(kid),
             _ptr(starts), _ptr(seeds), _ptr(lens), _ptr(r_out), _ptr(gap),
             _ptr(samp))
    if wide:
        thr, _C = kernel_tables(focc)
        rc = lib.bwt_gap_chain_mk_w(
            _ptr(focc.rows), focc.rows.shape[1], _ptr(thr), focc.sigma,
            *lanes, int(rate), len(seeds), stream)
        form = "64"
    elif isinstance(focc, WaveletRows):
        width = wr.symbol_dtype(focc.sigma).itemsize
        rc = lib.bwt_gap_chain_mk_wm(
            _ptr(focc.blocks), focc.nblk, focc.levels, _ptr(focc.Zc),
            _ptr(focc.start), focc.sigma, wr.smem_bytes(focc.sigma), width,
            *lanes, int(rate), len(seeds), stream)
        form = "_wm" if width == 2 else "_wm32"
    else:
        rc = lib.bwt_gap_chain_mk(_ptr(focc.rows), focc.rows.shape[1],
                                  *lanes, int(rate), len(seeds), stream)
        form = ""
    LAUNCHES[("chain" if gap is not None else "anchor") + form] += 1
    if rc != 0:
        raise RuntimeError("CUDA kernel launch failed: %s (%d)"
                           % (lib.bwt_error_string(rc).decode(), rc))
    return r_out


def chain_walk_mk(focc, text, gt, c_first, table, kid, starts, seeds, lens,
                  gap, samp, rate: int) -> torch.Tensor:
    """The recording walk of a level: final global ranks (int64);
    ``gap`` and ``samp`` are updated in place."""
    if not _on_cuda(seeds):
        return gap_chain_mk_plain(focc, text, gt, c_first, table, kid,
                                  starts, seeds, lens, gap, samp, rate)
    return word_values(focc, _launch(focc, text, gt, c_first, table, kid,
                                     starts, seeds, lens, gap, samp, rate))


def anchor_walk_mk(focc, text, gt, c_first, table, kid, starts, seeds,
                   lens) -> torch.Tensor:
    """The anchor walk of a level: final global ranks (int64) only."""
    if not _on_cuda(seeds):
        return gap_chain_mk_plain(focc, text, gt, c_first, table, kid,
                                  starts, seeds, lens)
    return word_values(focc, _launch(focc, text, gt, c_first, table, kid,
                                     starts, seeds, lens))


# ------------------------------------------------------------ the runner

class _MergeSpec:
    """Host bookkeeping of one pair merge inside the batch."""

    def __init__(self, k, s, m, e, isa_m, rbase, rate):
        self.k = k
        self.s, self.m, self.e = int(s), int(m), int(e)
        self.isa_m = int(isa_m)
        self.rbase = int(rbase)          # global rank of the local rank 0
        self.gap_size = self.e - self.m
        self.lo0 = (self.s // TEXT_BLOCK) * TEXT_BLOCK
        # gt bits span the whole pair [lo0, e-1), so a longer lookback
        # never moves the layout: only the coverage grows
        self.gt_bytes = max(1, (self.e - 1 - self.lo0 + 7) // 8)
        self.gt_base = 0                 # byte base in the level's array
        self.gt_cap = 0                  # positions < gt_cap have bits
        self.samp_p0 = self.s + (-self.s) % rate
        self.nsamp = len(range(self.samp_p0, self.m, rate))
        self.samp_base = 0
        self.T = 0
        self.starts = self.lens = self.seeds = self.final_rs = None


class BatchedGapRunner:
    """Gap histograms of K same-level pair merges in shared launches.

    ``merges`` is a list of (s, m, e, isa_m, first_hist) and
    ``right_packed`` the right regions' packed BWT bytes on the device
    (``bits`` per symbol); ``text_dev`` / ``text_host`` are the engine's
    dense text.  After ``compute()``, ``view(k)`` gives merge k's results
    (``final_rs``, ``gap``, ``harvest_samples``); ``gap`` is the level's
    histogram on the device, one uint32 cell per global rank held as
    int32 (``ops/devzip.py::gap_cum`` reads it so), and
    ``chain_ms`` the recording walk's time (CUDA events on the card).
    With ``wide`` (one merge only) the rank rows are wide rows and every
    rank, constant, sample and histogram cell is int64 (module
    docstring).

    Under a ``mesh`` (``parallel/mesh.py``; every rank builds the same
    runner) the lane axis is cut into ``mesh.world`` contiguous equal
    parts, which gives whole merges to ranks, and each rank walks its
    part alone: the anchors' and the chains' final ranks come together in
    one ``all_gather`` each, the chains' histograms in one
    ``all_reduce(SUM)`` and their samples (-1 where unwritten, each slot
    written by one lane) in one ``all_reduce(MAX)``.  The anchor/chain
    check and everything downstream then run unchanged on every rank.
    ``lane_bucket`` must divide by the world size.  ``walks`` is the
    object whose ``anchor_bounds`` and ``run_chains`` walk the lanes: the
    runner itself, or a ``parallel/shocc.py::ShardedOccGapRunner``
    wrapped around it."""

    def __init__(self, text_dev: torch.Tensor, text_host: np.ndarray,
                 sigma: int, merges, right_packed, bits: int,
                 lane_bucket: int = 1 << 16, sample_rate: int = 1,
                 nthreads: int = 4, log=None, phase=None,
                 layout: str = "auto", wide: bool = False, mesh=None):
        if sample_rate < 1:
            raise ValueError("sample_rate must be >= 1")
        if mesh is not None and lane_bucket % mesh.world:
            raise ValueError("lane_bucket %d does not divide by %d ranks"
                             % (lane_bucket, mesh.world))
        self.mesh = mesh
        self._walks = None
        self.text_dev = text_dev
        self.text = text_host
        self.n = len(text_host)
        self.sigma = int(sigma)
        self.lane_bucket = lane_bucket
        self.sample_rate = int(sample_rate)
        self.nthreads = nthreads
        self.log = log
        self.phase = phase or (lambda name: contextlib.nullcontext())
        dev = text_dev.device
        self.wide = wide
        with self.phase("rank rows"):
            if bits >= 16:
                if len(merges) != 1 or wide:
                    raise ValueError("a runner over wavelet rows holds one "
                                     "narrow merge")
                (_s, m, e, _i, _h), = merges
                self.focc = wr.build_wavelet(
                    unpack_bits(right_packed[0], bits, e - m), self.sigma)
                rbases = np.zeros(1, np.int64)
            elif wide:
                if len(merges) != 1:
                    raise ValueError("a wide runner holds one merge")
                (_s, m, e, _i, _h), = merges
                self.focc = build_focc_from_packed(
                    right_packed[0], e - m, self.sigma, bits, layout,
                    wide=True)
                rbases = np.zeros(1, np.int64)
            else:
                self.focc, rbases = build_focc_concat(
                    right_packed, [m[2] - m[1] for m in merges], self.sigma,
                    bits, layout)
        if not wide and self.focc.n + 256 >= 1 << 32:
            raise ValueError("level rank space must stay 256 short of 2^32")
        K = len(merges)
        self.specs: List[_MergeSpec] = []
        c_first = np.zeros((K, self.sigma), np.int64)
        table = np.zeros((K, MERGE_WORDS), np.int64)
        gt_off = samp_off = 0
        for k, (s, m, e, isa_m, first_hist) in enumerate(merges):
            sp = _MergeSpec(k, s, m, e, isa_m, rbases[k], self.sample_rate)
            sp.gt_base, sp.samp_base = gt_off, samp_off
            gt_off += sp.gt_bytes
            samp_off += sp.nsamp
            sp.sym_last = int(text_host[(sp.e - 1) % self.n])
            # c_first[c] = rbase + number of right rotations starting
            # with a symbol < c: pre-offset, so ranks stay global
            c_first[k] = sp.rbase + np.concatenate(
                [[0], np.cumsum(first_hist)[:-1]])
            table[k] = (k * self.sigma, sp.rbase + sp.isa_m,
                        int(text_host[(sp.m - 1) % self.n]), sp.sym_last,
                        sp.lo0, sp.gt_base, sp.samp_base, sp.samp_p0)
            self.specs.append(sp)
        self.c_first = torch.from_numpy(self._words(c_first.reshape(-1))).to(
            dev)
        self.table = torch.from_numpy(self._words(table)).to(dev)
        self._gt = np.zeros(gt_off, np.uint8)
        self.gt_dev = torch.zeros(gt_off, dtype=torch.uint8, device=dev)
        self._nsamp = samp_off
        self.gap = None
        self._samp = None
        self.chain_ms = self.chain_steps = 0

    @property
    def walks(self):
        """What walks the lanes: this runner, or the walker set here.  No
        attribute of the runner refers to the runner itself: a reference
        cycle would keep a level's rows and histogram on the device until
        the cyclic collector ran."""
        return self if self._walks is None else self._walks

    @walks.setter
    def walks(self, walker) -> None:
        self._walks = walker

    def _words(self, a) -> np.ndarray:
        """Host values as the kernel's words: uint32 bits in int32, or
        int64 on wide rows."""
        return np.asarray(a, np.int64) if self.wide else u32_bits(a)

    # ---------------------------------------------------------------- gt

    def _ensure_gt(self, caps: List[int]) -> None:
        """Extend each merge's wrap-term bits to cover walk positions
        [s_k, caps[k]); only the new bits are computed, and only the
        bytes they touch go to the device."""
        for sp, cap in zip(self.specs, caps):
            cap = min(cap, sp.e - 1)
            if cap <= sp.gt_cap:
                continue
            with self.phase("gt bits (host)"):
                lo = max(sp.s, sp.gt_cap)
                ps, gt = wrap_bits(self.text, lo, cap, sp.e, sp.sym_last,
                                   self.nthreads)
                first = lo - ((lo - sp.lo0) & 7)   # byte-aligned start
                bits = np.zeros(cap - first, np.uint8)
                bits[ps - first] = gt
                a = sp.gt_base + ((first - sp.lo0) >> 3)
                b = sp.gt_base + ((cap - sp.lo0 + 7) >> 3)
                self._gt[a:b] |= np.packbits(bits, bitorder="little")
                del bits
                self.gt_dev[a:b] = torch.from_numpy(self._gt[a:b]).to(
                    self.gt_dev.device)
                sp.gt_cap = cap

    # ------------------------------------------------------------- lanes

    def _lanes(self, kid, starts, seeds, lens):
        dev = self.text_dev.device
        return (torch.from_numpy(np.asarray(kid, np.int32)).to(dev),
                torch.from_numpy(np.asarray(starts, np.int64)).to(dev),
                torch.from_numpy(self._words(seeds)).to(dev),
                torch.from_numpy(np.asarray(lens, np.int32)).to(dev))

    def _caps(self, kid, walk_start) -> List[int]:
        caps = np.zeros(len(self.specs), np.int64)
        np.maximum.at(caps, kid, walk_start + 1)
        return caps.tolist()

    def _anchor_pass(self, kid, starts, lbs, lo_seeds, hi_seeds):
        """Lane j walks positions starts[j] + lbs[j] down to starts[j] + 1
        from each of the global seeds lo_seeds[j] and hi_seeds[j]; returns
        the two arrays of final ranks."""
        walk_start = starts + lbs
        self._ensure_gt(self._caps(kid, walk_start))
        return self.walks.anchor_bounds(kid, walk_start, lbs, lo_seeds,
                                        hi_seeds)

    def anchor_bounds(self, kid, starts, lens, lo_seeds, hi_seeds):
        """The anchor walk from both bounds of every lane: one launch
        each."""
        return (self.anchor(kid, starts, lo_seeds, lens),
                self.anchor(kid, starts, hi_seeds, lens))

    def _part(self, lanes: int) -> slice:
        """This rank's contiguous part of ``lanes`` lanes cut into equal
        parts (the last ones short or empty); all lanes without a mesh."""
        if self.mesh is None:
            return slice(0, lanes)
        per = -(-lanes // self.mesh.world)
        a = min(lanes, self.mesh.rank * per)
        return slice(a, min(lanes, a + per))

    def _gather(self, part: np.ndarray, lanes: int) -> np.ndarray:
        """Every rank's part of the lanes' final ranks, in lane order."""
        if self.mesh is None:
            return part
        from ..parallel.mesh import all_gather
        per = -(-lanes // self.mesh.world)
        t = torch.zeros(per, dtype=torch.int64, device=self.mesh.device)
        t[:len(part)] = torch.from_numpy(part)
        return all_gather(self.mesh, t).reshape(-1)[:lanes].cpu().numpy()

    def anchor(self, kid, starts, seeds, lens) -> np.ndarray:
        """The anchor walk of the lanes (``anchor_walk_mk``; under a mesh
        this rank's part): their final global ranks."""
        p = self._part(len(kid))
        kd, st, sd, ln = self._lanes(kid[p], starts[p], seeds[p], lens[p])
        return self._gather(anchor_walk_mk(
            self.focc, self.text_dev, self.gt_dev, self.c_first, self.table,
            kd, st, sd, ln).cpu().numpy(), len(kid))

    def run_chains(self, kid, starts, seeds, lens) -> np.ndarray:
        """The recording walk of the lanes (``chain_walk_mk``; under a mesh
        this rank's part, then the reductions of the class docstring):
        leaves the histogram in ``gap`` and the samples in ``_samp``,
        returns the final global ranks."""
        dev = self.text_dev.device
        word = torch.int64 if self.wide else torch.int32
        self.gap = torch.zeros(self.focc.n + 1, dtype=word, device=dev)
        self._samp = torch.full((self._nsamp,), -1, dtype=word, device=dev)
        p = self._part(len(kid))
        kd, st, sd, ln = self._lanes(kid[p], starts[p], seeds[p], lens[p])
        # the walk alone: device time between two events on the card, the
        # host clock around the plain version on the CPU
        on_card = dev.type == "cuda"
        if on_card:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
        else:
            t0 = time.monotonic()
        final = chain_walk_mk(self.focc, self.text_dev, self.gt_dev,
                              self.c_first, self.table, kd, st, sd, ln,
                              self.gap, self._samp, self.sample_rate)
        if on_card:
            t1.record()
        final = final.cpu().numpy()          # on the card: ends the walk
        self.chain_ms = (t0.elapsed_time(t1) if on_card
                         else (time.monotonic() - t0) * 1e3)
        self.chain_steps = int(lens[p].sum())
        if self.mesh is not None:
            from ..parallel.mesh import all_reduce
            self.gap = all_reduce(self.mesh, self.gap, "sum")
            vals = torch.where(self._samp == -1, -1,
                               word_values(self.focc, self._samp))
            vals = all_reduce(self.mesh, vals, "max")
            self._samp = vals if self.wide else as_u32_bits(vals)
        return self._gather(final, len(kid))

    def _lane_budget(self, spec: _MergeSpec) -> int:
        """Lanes of one merge: its left block's share of the level."""
        total = sum(sp.m - sp.s for sp in self.specs)
        return max(1, (spec.m - spec.s) * self.lane_bucket // max(1, total))

    def anchor_all(self, anchor_lookback: int = 64) -> None:
        """Seed ranks of every merge's interior lane boundaries, all
        merges contracted jointly: two launches per lookback round, the
        lookback growing x4 until every seed is determined."""
        kid_l, starts_l = [], []
        for sp in self.specs:
            block_len = sp.m - sp.s
            T = max(1, min(self._lane_budget(sp), block_len // 64 or 1))
            bounds = np.linspace(sp.s, sp.m, T + 1).astype(np.int64)
            sp.starts = bounds[1:] - 1
            sp.lens = np.diff(bounds)
            sp.T = T
            sp.seeds = np.zeros(T, np.int64)
            sp.seeds[T - 1] = sp.rbase + sp.isa_m
            if T > 1:
                kid_l.append(np.full(T - 1, sp.k, np.int64))
                starts_l.append(sp.starts[:T - 1])
        if not kid_l:
            return
        kid = np.concatenate(kid_l)
        starts = np.concatenate(starts_l)
        gapsz = np.array([self.specs[k].gap_size for k in kid], np.int64)
        rbase = np.array([self.specs[k].rbase for k in kid], np.int64)
        e_arr = np.array([self.specs[k].e for k in kid], np.int64)
        seeds = np.zeros(len(kid), np.int64)
        todo = np.arange(len(kid))
        lb = anchor_lookback
        while len(todo):
            lbs = np.minimum(min(lb, self.n), (e_arr[todo] - 2)
                             - starts[todo])
            lbs = np.maximum(lbs, 1)
            # a round past the first re-walks the lanes left undetermined
            with (trace.span("merge.anchor_extend", lanes=len(todo),
                             lookback=lb) if lb > anchor_lookback
                  else contextlib.nullcontext()):
                lo, hi = self._anchor_pass(kid[todo], starts[todo], lbs,
                                           rbase[todo],
                                           rbase[todo] + gapsz[todo])
            ok = lo == hi
            seeds[todo[ok]] = lo[ok]
            todo = todo[~ok]
            if len(todo) and lb >= self.n:
                raise AssertionError(
                    "anchor unresolved at full lookback — equal-rotation "
                    "boundary should be impossible for interior anchors")
            lb = min(lb * 4, self.n)
            if len(todo) and self.log:
                self.log.v("batched anchors: lookback extended to %d for "
                           "%d lanes" % (lb, len(todo)))
        off = 0
        for sp in self.specs:
            if sp.T > 1:
                sp.seeds[:sp.T - 1] = seeds[off:off + sp.T - 1]
                off += sp.T - 1

    # ------------------------------------------------------------- chains

    def compute(self, anchor_lookback: int = 64) -> None:
        """Anchors and chains of all merges: leaves the level histogram
        in ``gap``, each merge's local final ranks in its spec, and
        checks every lane's final rank against the anchored seed of the
        lane to its left."""
        with self.phase("anchors"):
            self.anchor_all(anchor_lookback)
        kid = np.concatenate(
            [np.full(sp.T, sp.k, np.int64) for sp in self.specs])
        starts = np.concatenate([sp.starts for sp in self.specs])
        lens = np.concatenate([sp.lens for sp in self.specs])
        seeds = np.concatenate([sp.seeds for sp in self.specs])
        self._ensure_gt(self._caps(kid, starts))
        with self.phase("chains"):
            final = self.walks.run_chains(kid, starts, seeds, lens)
        lane0 = 0
        for sp in self.specs:
            sp.final_rs = final[lane0:lane0 + sp.T] - sp.rbase
            lane0 += sp.T
            seeds_loc = sp.seeds - sp.rbase
            if not np.array_equal(sp.final_rs[1:], seeds_loc[:-1]):
                bad = int(np.flatnonzero(
                    sp.final_rs[1:] != seeds_loc[:-1])[0])
                raise AssertionError(
                    "anchor/chain mismatch (merge %d lane %d): %d != %d"
                    % (sp.k, bad + 1, sp.final_rs[bad + 1], seeds_loc[bad]))

    # ------------------------------------------------------------ results

    def view(self, k: int) -> "_MergeView":
        return _MergeView(self, self.specs[k])


class _MergeView:
    """The results of one merge of the batch."""

    def __init__(self, runner: BatchedGapRunner, spec: _MergeSpec):
        self._r = runner
        self._sp = spec
        self.final_rs = spec.final_rs

    @property
    def gap(self) -> torch.Tensor:
        """The merge's histogram: its gap_size + 1 cells of the level's."""
        sp = self._sp
        return self._r.gap[sp.rbase:sp.rbase + sp.gap_size + 1]

    def gap_checksum(self) -> int:
        return int(word_values(self._r.focc, self.gap).sum())

    def harvest_samples(self) -> Tuple[np.ndarray, np.ndarray]:
        """(positions, local R values) at the sample_rate-aligned
        positions of the merge's left block, ascending."""
        sp, rate = self._sp, self._r.sample_rate
        raw = self._r._samp[sp.samp_base:sp.samp_base + sp.nsamp]
        seen = (raw != -1).cpu().numpy()
        vals = word_values(self._r.focc, raw).cpu().numpy() - sp.rbase
        pos = sp.samp_p0 + rate * np.arange(sp.nsamp, dtype=np.int64)
        return pos[seen], vals[seen]


def batched_inputs_from_jax(jax_runner, sample_rate: int) -> dict:
    """The level inputs a reference ``BatchedGapRunner`` computed, after
    its ``compute()``, as the numpy arguments of ``gap_chain_mk_plain``
    (``c_first``, ``table``, ``gt``, ``kid``, ``starts``, ``seeds``,
    ``lens``) plus per merge ``rbase``, ``samp_base`` and ``nsamp``.  The
    reference's gt rows are 32 bytes per 256 positions from each merge's
    ``lo0``, so its row base times 32 is the merge's byte base here."""
    specs = jax_runner.specs
    K = len(specs)
    table = np.zeros((K, MERGE_WORDS), np.int64)
    sigma = int(jax_runner.sigma)
    samp_off = 0
    info = []
    for k, sp in enumerate(specs):
        s, m = int(sp.s), int(sp.m)
        p0 = s + (-s) % sample_rate
        nsamp = len(range(p0, m, sample_rate))
        table[k] = (k * sigma, int(jax_runner._isa_g[k]),
                    int(jax_runner._symb[k]), int(jax_runner._syml[k]),
                    int(sp.lo0), int(sp.gt_base) * (TEXT_BLOCK // 8),
                    samp_off, p0)
        info.append({"rbase": int(sp.rbase), "samp_base": samp_off,
                     "nsamp": nsamp, "samp_p0": p0})
        samp_off += nsamp
    kid, starts, lens = jax_runner._lane_maps[:3]
    return {
        "c_first": u32_bits(np.asarray(jax_runner._cbase_rows).reshape(-1)),
        "table": u32_bits(table),
        "gt": np.asarray(jax_runner._gt_packed, np.uint8).reshape(-1),
        "kid": np.asarray(kid, np.int32),
        "starts": np.asarray(starts, np.int64),
        "seeds": u32_bits(np.concatenate([sp.seeds for sp in specs])),
        "lens": np.asarray(lens, np.int32),
        "merges": info,
        "nsamp": samp_off,
    }
