"""Scaled blockwise BWT construction — the merge engine on the device.

Port of ``bwtb3m_tpu/engine/merge_scaled.py`` (narrow merges, batched
levels and the per-pair path).  The text is cut into fixed blocks of
``max_block_symbols``; each block's suffixes are sorted by the windowed
doubling sort (``ops/windowsort.py``) and kept as a region: its BWT as
packed bytes on the device, plus

    samp_pos / samp_rank   local ranks at the multiples of the preisa rate
    r_start                local rank of the rotation at the region start
    hist                   symbol histogram of text[s:e]

Regions merge pairwise up a balanced tree (reference: SURVEY.md section
3.1, arXiv:1604.06687): the right regions' rank rows are built on the
device, anchored gap chains give the gap histogram (``ops/gapbatch.py``,
the CUDA kernel ``csrc/gap_chain.cu::bwt_gap_chain_mk``), and the two
BWTs are zipped on the device (``ops/devzip.py``).  A level with two or
more pairs runs its anchors and chains as one lane population over
concatenated rank rows when ``batch_merges`` is set, the build is not
resuming and the level's state fits the device budget
(``util/devices.py::device_budget``); otherwise pair by pair, each pair
a batch of one through the same runner.  Both ways give the same regions.

Under a mesh (``parallel/``: one process per rank, every rank running
the same build) the merges' walks are sharded: a level's lanes are cut
over the ranks (``ops/gapbatch.py``), or a pair merge's rank rows and
histogram by rank range (``parallel/shocc.py``) when they pass the
device budget (``_mesh_wants_occ_sharding``).

Sample ranks update in O(#samples): a left position p gains R(p) from
the chains, a right rank r gains cnt_le[r].  Completed regions are checkpointed (``engine/checkpoint.py``)
and a build stopped by ``<output>.stop`` or a crash resumes from them.
The BWT crosses to the host once, at the end.

More than 256 distinct symbols (the reference sends such a text to its
legacy full-SA engine, ``engine/merge.py::blockwise_bwt``): the text is
dense ids, uint16 up to 65,536 symbols (on the device as int16 of the
same bits) and uint32 past them, up to 2^21 (int32 on the device);
regions pack at 16 or 32 bits; the block sorts take those symbols; the
gt bits come from the native comparator's uint16 or uint32 form; each
merge's right region gets its own wavelet rank rows
(``ops/wavelet_rows.py``, up to 7 levels) and the chains run through
``bwt_gap_chain_mk_wm`` (its uint16 or uint32 form), so the merges run
pair by pair
(``_level_fits_batched`` refuses such a level) and texts stay below 2^31
symbols.  As in the reference's legacy engine there are no checkpoints;
``<output>.stop`` still stops the build.  The final region is not handed
to the result (``DeviceRowsHandle``): the tools build wavelet rows from
the file.

The wide path (the reference's ``_merge_pair_scaled`` wide branch): a
merge whose right region reaches (2^24-1)*256 - 2 ranks, whose left
block reaches 2^32 symbols or whose positions pass 2^32 (the narrow
kernel keeps them in uint32), and every merge under
``BWTB3M_FORCE_WIDE``, runs pair by pair through the runner's wide mode
(wide rank rows, int64 ranks and cells, the kernel's 64-bit form).  Its
zip and sample updates are the narrow merge's: they are int64 in torch
throughout, so the reference's (hi, lo) zip twins
(``_finish_merge_dev_wide``) have no counterpart.  Texts of 2^35 symbols
or more are refused (``_validate_scale``).  The reference's fused and
pipelined block sorts, shape buckets and the uint16 histogram were relay
and XLA:TPU workarounds.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.devzip import (bits_for, cnt_le_at_ranks, device_interleave,
                          gap_cum, rows_from_host_bwt, rows_to_host_bwt,
                          pack_region)
from ..ops.focc_build import concat_layout
from ..ops.gapbatch import BatchedGapRunner
from ..ops.gapdev import cmp_rot
from ..ops.wavelet_rows import MAX_SYMBOLS, U16_SYMBOLS, symbol_values
from ..ops.windowsort import block_suffix_order
from ..parallel.mesh import any_rank
from ..parallel.shocc import ShardedOccGapRunner
from ..util.devices import device_budget
from ..util.log import VerboseLog
from ..util.phases import Phases
from .checkpoint import MergeCheckpointer, build_key, load_region_file, \
    pack_host
from .options import BwtOptions

ANCHOR_LOOKBACK = 64      # first anchor walk length, grown x4
TEXT_CHUNK = 1 << 26      # bytes of a memory-mapped text uploaded at a time
# peak device bytes of the windowed block sort per window symbol, whatever
# the alphabet: every tensor of ops/windowsort.py is int64 over the window
# (the shifted symbols, the ranks, the round's key, the order of the round
# before, the sort's two outputs and its internal double buffers), twelve
# of them at the peak.  chip_smoke.py holds the figure to the measured peak
# of every block sort of its genome build (80-92 bytes per symbol on an
# NVIDIA H100 80GB HBM3)
SORT_BYTES_PER_SYMBOL = 96


def host_symbol_dtype(sigma: int):
    """The host dtype of the engine's dense text over ``sigma`` symbols:
    uint8, uint16 past 256 symbols, uint32 past 65,536."""
    return (np.uint8 if sigma <= 256 else np.uint16
            if sigma <= U16_SYMBOLS else np.uint32)


@dataclasses.dataclass
class Region:
    s: int
    e: int
    packed: Optional[torch.Tensor]   # region bytes on the device
    bwt: Optional[np.ndarray]        # host uint8 (loaded from a checkpoint)
    samp_pos: np.ndarray             # int64, ascending
    samp_rank: np.ndarray            # int64 local ranks
    r_start: int                     # local rank of rotation s
    hist: np.ndarray                 # int64 [sigma] of text[s:e]


@dataclasses.dataclass
class DeviceRowsHandle:
    """Hand-off of a build's final region on the device.

    ``blockwise_bwt_scaled`` appends one to the caller's ``rows_out``
    list instead of keeping module state: ``packed`` holds the final
    BWT's packed symbols (``bits`` per symbol, the engine's dense
    alphabet) and the handle names the build they came from (n, sigma,
    symbol histogram), so ``engine/result.py::BwtResult.bind_device_rows``
    can refuse to bind them to a ``.bwt`` they do not belong to."""

    packed: torch.Tensor
    bits: int
    n: int
    sigma: int
    hist: np.ndarray          # int64 [sigma], the BWT's symbol histogram


class _Hole:
    """Placeholder for a tree node covered by a saved ancestor at resume:
    it keeps the level lists aligned and is never computed."""

    def __init__(self, s: int, e: int):
        self.s, self.e = s, e


class _Ctx:
    def __init__(self, text: np.ndarray, sigma: int, rate: int,
                 options: BwtOptions, log: Optional[VerboseLog],
                 lane_bucket: int, device: torch.device, phase: Phases,
                 nthreads: int = 4, budget: Optional[int] = None,
                 mesh=None):
        # a memory-mapped text (hostmem=) stays a memmap: the host reads
        # it page by page.  Past 256 symbols the dense ids are uint16, past
        # 65,536 uint32
        dt = host_symbol_dtype(sigma)
        mapped = isinstance(text, np.memmap) and text.dtype == dt
        self.text = (text if mapped
                     else np.ascontiguousarray(text, dtype=dt))
        self.n = len(self.text)
        self.sigma = sigma
        self.rate = rate
        self.options = options
        self.log = log or VerboseLog(0)
        self.lane_bucket = lane_bucket
        self.nthreads = nthreads
        self.device = device
        self.phase = phase
        self.bits = bits_for(sigma)
        self.ckpt_key = None
        self._budget = budget
        self.mesh = mesh
        with phase("text upload"):
            # uint16 ids travel as the int16 of their bits, uint32 ids
            # (below 2^21) as int32
            vdt, tdt = {np.uint8: (np.uint8, torch.uint8),
                        np.uint16: (np.int16, torch.int16),
                        np.uint32: (np.int32, torch.int32)}[dt]
            if mapped:
                # in chunks: never one host copy of n bytes
                self.text_dev = torch.empty(self.n, dtype=tdt,
                                            device=device)
                for a in range(0, self.n, TEXT_CHUNK):
                    b = min(self.n, a + TEXT_CHUNK)
                    self.text_dev[a:b] = torch.from_numpy(
                        np.array(self.text[a:b]).view(vdt)).to(device)
            else:
                self.text_dev = torch.from_numpy(self.text.view(vdt)).to(
                    device)

    def budget(self) -> int:
        """Device bytes a step may plan with now: the caller's figure, or
        what the device reports free."""
        if self._budget is not None:
            return self._budget
        return device_budget(self.device)


def _region_packed(ctx: _Ctx, reg: Region) -> torch.Tensor:
    """Device bytes of a region, uploaded from the host bytes of a
    region loaded from a checkpoint on first use."""
    if reg.packed is None:
        reg.packed = rows_from_host_bwt(reg.bwt, ctx.sigma, ctx.device)
    return reg.packed


def _region_bwt(ctx: _Ctx, reg: Region) -> np.ndarray:
    if reg.bwt is None:
        reg.bwt = rows_to_host_bwt(reg.packed, reg.e - reg.s, ctx.bits)
    return reg.bwt


def _packed_getter(ctx: _Ctx, reg: Region):
    """Zero-arg getter of a region's file bytes for the checkpoint
    thread: the device download happens in the worker."""
    if reg.packed is None:
        bwt, bits = reg.bwt, ctx.bits
        return lambda: pack_host(bwt, bits)
    packed = reg.packed
    return lambda: packed.cpu().numpy()


def _load_saved(ctx: _Ctx, avail, s: int, e: int) -> Region:
    data = load_region_file(avail[(s, e)], ctx.ckpt_key)
    if data is None:
        raise RuntimeError(
            "unreadable/stale checkpoint %s — remove it and restart"
            % avail[(s, e)])
    _s, _e, bwt, samp_pos, samp_rank, r_start, hist = data
    return Region(s, e, None, np.asarray(bwt, np.uint8),
                  np.asarray(samp_pos, np.int64),
                  np.asarray(samp_rank, np.int64), r_start,
                  np.asarray(hist, np.int64))


def region_from_jax(jax_region, sigma: int, device="cpu") -> Region:
    """Carry a reference ``_RegionS`` over to the port: its host BWT, or
    its packed device rows taken through numpy (so this module needs no
    JAX import) and trimmed to the region's bytes, plus its samples,
    r_start and histogram."""
    s, e = int(jax_region.s), int(jax_region.e)
    packed = bwt = None
    if jax_region.bwt is not None:
        bwt = np.asarray(jax_region.bwt, np.uint8)
    else:
        raw = np.asarray(jax_region.rows).view(np.uint8).reshape(-1)
        nbytes = ((e - s) * bits_for(sigma) + 7) // 8
        packed = torch.from_numpy(np.array(raw[:nbytes])).to(device)
    return Region(s, e, packed, bwt,
                  np.asarray(jax_region.samp_pos, np.int64),
                  np.asarray(jax_region.samp_rank, np.int64),
                  int(jax_region.r_start),
                  np.asarray(jax_region.hist, np.int64))


def _plan_blocks_fixed(n: int, max_block: int) -> List[Tuple[int, int]]:
    """Fixed-size blocks (a multiple of 256) plus a short tail."""
    size = max(256, (min(max_block, n) // 256) * 256)
    return [(s, min(n, s + size)) for s in range(0, n, size)]


def _device_window(ctx: _Ctx, s: int, W: int) -> torch.Tensor:
    """The circular window text[s : s+W] (on the device)."""
    s %= ctx.n
    if s + W <= ctx.n:
        return ctx.text_dev[s:s + W]
    idx = torch.arange(s, s + W, device=ctx.device) % ctx.n
    return ctx.text_dev[idx]


# --------------------------------------------------------------- block sort

def _resolve_tie_groups(ctx: _Ctx, s: int, e: int, lo_order, hi_order):
    """Order the window sort's residual tie groups by the rotation-e
    reduction instead of growing the window (host code over the native
    comparator, carried over from the reference).

    For p < q in the block tying through the block end, rot_p vs rot_q
    reduces to cmp(rot_{e-(q-p)}, rot_e).  A maximal tie group's members
    make text[p_min..e) periodic in every pairwise gap, so an arithmetic
    group is ordered by one comparator call on its gap; other groups sort
    by the comparator over their distinct gaps.  Equal rotations order by
    position.  Returns None for a mixed group of more than 4096 members
    (the caller then grows the window)."""
    n = ctx.n
    lo_np = lo_order.cpu().numpy().astype(np.int64)
    hi_np = hi_order.cpu().numpy().astype(np.int64)
    idx = np.flatnonzero(lo_np != hi_np)
    sa = hi_np.copy()
    # tie components by interval closure over both orders from each
    # mismatch run (the lo and hi paddings break ties in opposite
    # directions; "tie" is not transitive)
    inv_lo = np.empty(len(lo_np), np.int64)
    inv_lo[lo_np] = np.arange(len(lo_np))
    inv_hi = np.empty(len(hi_np), np.int64)
    inv_hi[hi_np] = np.arange(len(hi_np))
    raw_runs = np.split(idx, np.flatnonzero(np.diff(idx) != 1) + 1)
    runs = []
    last_end = -1
    for run in raw_runs:
        if len(run) == 0 or run[-1] <= last_end:
            continue
        i0, i1 = int(run[0]), int(run[-1])
        while True:
            ls = inv_lo[hi_np[i0:i1 + 1]]
            hs = inv_hi[lo_np[i0:i1 + 1]]
            ni0 = min(i0, int(ls.min()), int(hs.min()))
            ni1 = max(i1, int(ls.max()), int(hs.max()))
            if (ni0, ni1) == (i0, i1):
                break
            i0, i1 = ni0, ni1
        runs.append(np.arange(i0, i1 + 1))
        last_end = i1

    def cmp_e(gaps: np.ndarray) -> np.ndarray:
        return cmp_rot(ctx.text, e % n, (e - gaps).astype(np.int64),
                       ctx.nthreads)

    for run in runs:
        if len(run) < 2:
            continue
        hi_run = sa[run]
        lo_run = lo_np[run]
        pure_tie = np.array_equal(lo_run, hi_run[::-1])
        pos = np.sort(hi_run)
        gaps = np.diff(pos)
        if pure_tie and (gaps == gaps[0]).all():
            f = int(cmp_e(np.array([gaps[0]]))[0])
            ordered = pos if f <= 0 else pos[::-1]
        else:
            if len(pos) > 4096:
                return None
            hi_slot = {int(p): i for i, p in enumerate(hi_run)}
            lo_slot = {int(p): i for i, p in enumerate(lo_run)}
            dg = np.unique(
                (pos[None, :] - pos[:, None])[np.triu_indices(len(pos), 1)])
            fmap = dict(zip(dg.tolist(), cmp_e(dg).tolist()))

            def c(a, b):
                if a == b:
                    return 0
                h = -1 if hi_slot[a] < hi_slot[b] else 1
                lo = -1 if lo_slot[a] < lo_slot[b] else 1
                if h == lo:
                    return h  # window-decided pair
                f = fmap[abs(b - a)]
                if f == 0:
                    return -1 if a < b else 1  # equal rotations: position
                return f if a < b else -f

            ordered = np.array(sorted(pos.tolist(),
                                      key=functools.cmp_to_key(c)),
                               dtype=np.int64)
        sa[run] = ordered
    return torch.from_numpy(sa).to(ctx.device)


def _sort_block(ctx: _Ctx, s: int, e: int) -> Region:
    """Rotation order of block [s, e) by the windowed doubling sort: the
    lookahead starts at 1024 and grows x4 up to max(1024, largelcpthres);
    residual ties then go to ``_resolve_tie_groups``, and only a giant
    mixed tie group grows the window towards n."""
    n = ctx.n
    block_len = e - s
    la_cap = min(max(1024, ctx.options.large_lcp_thres), n)
    la = min(1024, la_cap)
    while True:
        W = min(block_len + la, block_len + n)
        need = W * SORT_BYTES_PER_SYMBOL
        if need > ctx.budget():
            raise MemoryError(
                "sorting block [%d,%d) with a window of %d symbols needs "
                "about %d bytes on %s and %d are free: lower mem= (blocks "
                "of mem/16 symbols)" % (s, e, W, need, ctx.device,
                                        ctx.budget()))
        lo_order, hi_order, mism = block_suffix_order(
            _device_window(ctx, s, W), block_len, ctx.sigma)
        if mism == 0:
            sa_local = lo_order
            break
        if la >= la_cap:
            ctx.log.v("block [%d,%d): resolving ties via rotation "
                      "comparator at lookahead %d" % (s, e, la))
            sa_local = _resolve_tie_groups(ctx, s, e, lo_order, hi_order)
            if sa_local is not None:
                break
            if la >= n:
                sa_local = hi_order
                break
            la_cap = n      # giant mixed tie group: grow the window
        la = min(la * 4, la_cap)
        ctx.log.v("block [%d,%d): lookahead extended to %d" % (s, e, la))
    return _derive_region(ctx, s, e, sa_local)


def _derive_region(ctx: _Ctx, s: int, e: int, sa_local: torch.Tensor
                   ) -> Region:
    """Region pieces from a block's local rotation order: the BWT symbol
    of each sorted suffix text[(s + sa - 1) mod n], packed; the inverse
    permutation's values at the sampled positions and at the block start;
    the block's symbol histogram."""
    block_len = e - s
    pos = sa_local + s
    prev = torch.where(pos == 0, ctx.n - 1, pos - 1)
    packed = pack_region(ctx.text_dev[prev], ctx.bits)
    del pos, prev
    inv = torch.empty(block_len, dtype=torch.int64, device=ctx.device)
    inv[sa_local] = torch.arange(block_len, device=ctx.device)
    first = (-s) % ctx.rate
    spos = np.arange(s + first, e, ctx.rate, dtype=np.int64)
    sranks = inv[first::ctx.rate].cpu().numpy()
    r_start = int(inv[0])
    hist = torch.bincount(symbol_values(ctx.text_dev[s:e]),
                          minlength=ctx.sigma)[
        :ctx.sigma].cpu().numpy().astype(np.int64)
    return Region(s, e, packed, None, spos, sranks, r_start, hist)


# ------------------------------------------------------------------ merges

def _finish_merge(ctx: _Ctx, left: Region, right: Region, runner,
                  cnt_le: torch.Tensor) -> Region:
    """Zip and sample update of one merge from its chains' results:
    ``runner`` (a view of the level's ``BatchedGapRunner``) has ``gap``
    (the merge's histogram, B + 1 cells), ``final_rs`` and
    ``harvest_samples()``; ``cnt_le`` is the histogram's inclusive
    cumsum."""
    A, B = left.e - left.s, right.e - right.s
    phase = ctx.phase
    with phase("zip"):
        total = int(cnt_le[-1])
        if total != A:
            raise AssertionError("gap histogram of merge [%d,%d,%d) sums "
                                 "to %d, not %d" % (left.s, left.e, right.e,
                                                    total, A))
        cnt_right = cnt_le_at_ranks(runner.gap, right.samp_rank, cnt_le)
        merged = device_interleave(_region_packed(ctx, left), A,
                                   _region_packed(ctx, right), B,
                                   runner.gap, ctx.bits, cnt_le)
    del cnt_le
    with phase("samples"):
        hpos, hval = runner.harvest_samples()
        if not np.array_equal(hpos, left.samp_pos):
            raise AssertionError(
                "chain sample harvest mismatch: %d vs %d positions"
                % (len(hpos), len(left.samp_pos)))
        pos = np.concatenate([left.samp_pos, right.samp_pos])
        rank = np.concatenate([left.samp_rank + hval,
                               right.samp_rank + cnt_right])
    return Region(left.s, right.e, merged, None, pos, rank,
                  int(left.r_start + runner.final_rs[0]),
                  left.hist + right.hist)


def _is_wide(l, r) -> bool:
    """Whether the merge of ``l`` and ``r`` needs the wide path: the
    reference's bounds (right region, left block), the port's narrow
    kernel's uint32 positions (its lanes walk the left block, so it ends
    at 2^32 at most), or ``BWTB3M_FORCE_WIDE``."""
    return (r.e - r.s + 2 > ((1 << 24) - 1) * 256 or l.e - l.s >= (1 << 32)
            or l.e > 1 << 32 or bool(os.environ.get("BWTB3M_FORCE_WIDE")))


def _validate_scale(n: int) -> None:
    """Texts of 2^35 symbols or more: the wide rank rows track THR_K = 8
    wraps of a symbol's occ word (``ops/wideocc.py``)."""
    if n >= 1 << 35:
        raise ValueError("texts >= 2^35 symbols exceed the wide rank rows' "
                         "THR_K wrap tracking (ops/wideocc.py)")


def level_bytes_estimate(pairs, sigma: int, bits: int,
                         wide: bool = False) -> int:
    """Device bytes a batch of merges allocates beyond the text and the
    regions it starts from, counted from the tensors it makes: the
    concatenated rank rows; the level's int32 histogram and its int64
    cumsum (12 bytes per rank; a wide merge's histogram is int64 and its
    cumsum is taken in place: 8 bytes per rank); the gt bits over every
    pair's span; the
    merged regions as they accumulate; and the largest single transient:
    a region's rank-row build (about 12 bytes per symbol: the unpacked
    symbols, one int32 running count, the plane words), the scratch of
    the histogram's int64 cumsum (8 bytes per rank: what ``torch.cumsum``
    of the int32 cells took; kept for ``ops/devzip.py::gap_cum``'s
    in-place cumsum of its own int64 copy, whose scratch torch does not
    document), or a pair's zip
    (``ops/devzip.py::device_interleave``: the int64 slots of the right
    symbols, both unpacked inputs and the unpacked output, and per chunk
    symbol a bool mask, its negation and the int64 indices of the mask's
    set cells, 10 bytes, counted as 12; or, at its end, the unpacked
    output, its padded and its masked copy and the packed bytes, 4 bytes
    per symbol).
    ``chip_smoke.py`` holds the
    figure to the measured peak of every level of its genome build."""
    from ..ops.devzip import ZIP_CHUNK
    right_lens = [r.e - r.s for _l, r in pairs]
    cls, roww, _first, total_rows = concat_layout(right_lens, sigma)
    rank_space = total_rows << cls.SHIFT
    spans = [r.e - l.s for l, r in pairs]
    build = 12 * max(right_lens)
    zips = max(max(8 * (r.e - r.s) + 2 * (r.e - l.s)
                   + 12 * min(ZIP_CHUNK, r.e - l.s), 4 * (r.e - l.s))
               for l, r in pairs)
    cells = 8 if wide else 12
    return ((total_rows + 1) * roww + cells * (rank_space + 1)
            + sum(spans) // 8 + sum(spans) * bits // 8
            + max(build, zips, 0 if wide else 8 * (rank_space + 1)))


def _level_fits_batched(ctx: _Ctx, pairs) -> bool:
    """Gate of the batched-level path: no pair needs the wide path (the
    reference never batches a wide level), the alphabet has at most 256
    symbols (past them each right region has its own wavelet rows), the
    level's rank space stays 256 short of 2^32, and its state fits the
    device budget."""
    if any(_is_wide(l, r) for l, r in pairs) or ctx.sigma > 256:
        return False
    cls, _roww, _first, total_rows = concat_layout(
        [r.e - r.s for _l, r in pairs], ctx.sigma)
    if (total_rows << cls.SHIFT) + 256 >= 1 << 32:
        return False
    budget = int(os.environ.get("BWTB3M_BATCH_HBM", 0)) or ctx.budget()
    fits = level_bytes_estimate(pairs, ctx.sigma, ctx.bits) <= budget
    if ctx.mesh is not None:
        # ranks sharing a card see each other's memory: one decision
        fits = not any_rank(ctx.mesh, not fits)
    return fits


def _mesh_wants_occ_sharding(ctx: _Ctx, runner) -> bool:
    """Under a mesh, whether a pair merge takes rank-range-sharded rows
    (``parallel/shocc.py``: memory scaling) over lane-sharded chains
    (compute scaling), by the reference's arithmetic: the lane path keeps
    the right region's rank rows, an int32 histogram and the text on
    every rank; past the device budget, the rows shard.
    ``BWTB3M_SHARD_OCC=1/0`` forces either way.  Every rank takes the
    same decision (``parallel/mesh.py::any_rank``)."""
    env = os.environ.get("BWTB3M_SHARD_OCC")
    if env is not None:
        return env != "0"
    budget = int(os.environ.get("BWTB3M_DEV_HBM", 0)) or ctx.budget()
    need = (runner.focc.rows.numel() + 4 * (runner.focc.n + 1)
            + ctx.text_dev.numel() * ctx.text_dev.element_size())
    return any_rank(ctx.mesh, need > budget)


def _level_runner(ctx: _Ctx, pairs) -> BatchedGapRunner:
    """The runner of a batch of merges, not yet computed: shared rank
    rows of the right regions (``ops/gapbatch.py``).  A single pair merge
    is a batch of one; a merge that needs the wide path (``_is_wide``) is
    always alone, through the runner's wide mode.  Under a mesh the lanes
    are sharded, or a pair merge's rows (``_mesh_wants_occ_sharding``)."""
    wide = any(_is_wide(l, r) for l, r in pairs)
    for l, r in pairs:
        assert r.s == l.e
    if wide and len(pairs) > 1:
        raise ValueError("a wide merge is not batched")
    # past 256 symbols texts stay below 2^31 (blockwise_bwt_scaled): never
    # wide, BWTB3M_FORCE_WIDE included, as the reference's legacy engine
    wide = wide and ctx.sigma <= 256
    phase = ctx.phase
    runner = BatchedGapRunner(
        ctx.text_dev, ctx.text, ctx.sigma,
        [(l.s, l.e, r.e, r.r_start, r.hist) for l, r in pairs],
        [_region_packed(ctx, r) for _l, r in pairs], ctx.bits,
        lane_bucket=ctx.lane_bucket, sample_rate=ctx.rate,
        nthreads=ctx.nthreads, log=ctx.log, phase=phase, wide=wide,
        mesh=ctx.mesh)
    if (ctx.mesh is not None and len(pairs) == 1 and not wide
            and ctx.sigma <= 256 and _mesh_wants_occ_sharding(ctx, runner)):
        ShardedOccGapRunner(ctx.mesh, runner)
        ctx.log.v("pair merge: rank rows and histogram sharded by rank "
                  "range over %d ranks" % ctx.mesh.world)
    return runner


def _merge_pairs(ctx: _Ctx, pairs) -> List[Region]:
    """Merge the adjacent regions (left, right) of every pair: anchors,
    chains and histogram of the level's runner (``_level_runner``), then
    each pair's zip."""
    runner = _level_runner(ctx, pairs)
    wide = runner.wide
    phase = ctx.phase
    runner.compute(ANCHOR_LOOKBACK)
    ctx.log.v("%s: %d lanes (%s), rank space %d, histogram %d bytes, chain "
              "walk of %d steps %.3f ms (%.2f G steps/s, %s)"
              % ("batched level: %d merges" % len(pairs) if len(pairs) > 1
                 else "wide pair merge" if wide else "pair merge",
                 sum(sp.T for sp in runner.specs),
                 " ".join(str(sp.T) for sp in runner.specs), runner.focc.n,
                 runner.gap.element_size() * runner.gap.shape[0],
                 runner.chain_steps,
                 runner.chain_ms,
                 runner.chain_steps / max(runner.chain_ms, 1e-9) / 1e6,
                 ctx.device))
    with phase("zip"):
        # one cumsum for the level; each merge's slice is rebased in place
        # (the slices are disjoint) when its turn comes.  A wide merge's
        # histogram is int64 already: its cumsum is taken in place (the
        # zip reads only the cumsum), 8 bytes per rank where a narrow
        # level's int64 copy of its int32 cells makes 12
        cum = runner.gap.cumsum_(0) if wide else gap_cum(runner.gap)
        rbases = torch.tensor([sp.rbase for sp in runner.specs],
                              device=cum.device)
        before = torch.where(rbases > 0, cum[(rbases - 1).clamp(min=0)], 0)
    out: List[Region] = []
    for k, (l, r) in enumerate(pairs):
        sp = runner.specs[k]
        cnt_le = cum[sp.rbase:sp.rbase + sp.gap_size + 1]
        cnt_le -= before[k]
        out.append(_finish_merge(ctx, l, r, runner.view(k), cnt_le))
    return out


# --------------------------------------------------------------- the tree

def blockwise_bwt_scaled(
    symbols: np.ndarray, sigma: int, options: BwtOptions,
    log: Optional[VerboseLog] = None, sample_rate: int = 1024,
    lane_bucket: int = 1 << 16, device="cuda", phase: Phases = None,
    rows_out: Optional[list] = None, budget: Optional[int] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(bwt uint8, preisa positions, preisa ranks, symbol hist) of the
    circular text ``symbols`` over [0, sigma), every device step on
    ``device``.  ``phase`` (a ``util.phases.Phases``) collects the wall
    time per phase.  ``rows_out``: an empty list that receives a
    ``DeviceRowsHandle`` of the final region when it ends on the device
    with every symbol present (no dense remap would apply), so the caller
    can bind it to the ``.bwt`` it is about to write.  ``budget``: the
    device bytes the gates plan with, instead of what the device reports
    free (``util/devices.py::device_budget``).

    ``mesh`` (``parallel/mesh.py``): every rank of the group calls this
    with the same text and options and runs the same build on its mesh
    device (block sorts, gt bits, the tree); the merges' walks are
    sharded over the ranks, by lanes (every batched level, and pair
    merges) or, for a pair merge past the device budget or under
    ``BWTB3M_SHARD_OCC=1``, by rank range (``_mesh_wants_occ_sharding``).
    Every rank returns the same result.  Under a mesh there are no
    checkpoints (their files would be every rank's), and a stop file
    stops every rank."""
    log = log or VerboseLog(1)
    device = mesh.device if mesh is not None else torch.device(device)
    phase = phase or Phases(device)
    text = symbols if isinstance(symbols, np.memmap) else np.asarray(symbols)
    n = len(text)
    if sigma > MAX_SYMBOLS or (sigma > 256 and n >= 1 << 31):
        raise ValueError("the scaled merge engine takes at most 2,097,152 "
                         "(2^21) dense symbols, and past 256 fewer than "
                         "2^31 symbols; rank-compact the alphabet first "
                         "(engine/api.py does)")
    _validate_scale(n)
    if mesh is not None and lane_bucket % mesh.world:
        raise ValueError("lane_bucket %d does not divide by %d ranks"
                         % (lane_bucket, mesh.world))
    ctx = _Ctx(text, sigma, sample_rate, options, log, lane_bucket, device,
               phase, budget=budget, mesh=mesh)
    blocks = _plan_blocks_fixed(n, options.max_block_symbols)
    log.v("scaled blockwise engine: %d blocks, rate=%d, lanes<=%d, %s"
          % (len(blocks), sample_rate, lane_bucket, device))

    # durable merge-tree checkpointing: resume from the deepest complete
    # saved tree nodes
    ckpt = None
    avail = {}
    if (options.checkpoint and options.tmp_prefix and len(blocks) > 1
            and sigma <= 256 and mesh is None):
        ctx.ckpt_key = build_key(ctx.text, sigma, sample_rate,
                                 blocks[0][1] - blocks[0][0])
        ckpt = MergeCheckpointer(options.tmp_prefix, ctx.ckpt_key, ctx.bits,
                                 min_symbols=options.checkpoint_min_symbols,
                                 log=log, phase=phase)
        avail = ckpt.scan()
        if avail:
            log.v("checkpoint resume: %d saved regions under %s"
                  % (len(avail), options.tmp_prefix))
            ckpt.adopt(avail)

    def _covered(s, e):
        return any(a <= s and e <= b for a, b in avail)

    regions: List[object] = []
    with phase("block sorts"):
        for s, e in blocks:
            if (s, e) in avail:
                regions.append(_load_saved(ctx, avail, s, e))
            elif avail and _covered(s, e):
                regions.append(_Hole(s, e))
            else:
                regions.append(_sort_block(ctx, s, e))
    log.v("block sorts: %d blocks in %.2fs"
          % (len(blocks), phase.wall.get("block sorts", 0.0)))

    stop_file = options.output_filename + ".stop"

    def stop_requested() -> bool:
        stop = os.path.exists(stop_file)
        return stop if mesh is None else any_rank(mesh, stop)

    total = len(regions) - 1
    done = 0
    level = regions
    ok = False
    def merge_level_pairwise(level, done):
        nxt: List[object] = []
        i = 0
        while i + 1 < len(level):
            if stop_requested():
                raise RuntimeError("stop requested via %s after %d/%d "
                                   "merges" % (stop_file, done, total))
            l, r = level[i], level[i + 1]
            span = (l.s, r.e)
            if span in avail:
                merged = _load_saved(ctx, avail, *span)
                log.v("resumed merge [%d,%d) from checkpoint" % span)
            elif isinstance(l, _Hole) or isinstance(r, _Hole):
                if not _covered(*span):
                    raise RuntimeError(
                        "inconsistent checkpoint state at [%d,%d): "
                        "clear %s_BWTREG1_reg_*"
                        % (span[0], span[1], options.tmp_prefix))
                merged = _Hole(*span)
            else:
                merged, = _merge_pairs(ctx, [(l, r)])
                if ckpt is not None:
                    # per completed merge: a crash mid-level resumes
                    # at the last finished pair
                    ckpt.offer(merged, _packed_getter(ctx, merged))
            done += 1
            log.v("merged [%d,%d): %d/%d" % (merged.s, merged.e, done,
                                             total))
            nxt.append(merged)
            i += 2
        if i < len(level):
            nxt.append(level[i])
        return nxt, done

    try:
        while len(level) > 1:
            pairs = [(level[i], level[i + 1])
                     for i in range(0, len(level) - 1, 2)]
            resuming = bool(avail) and (
                any(isinstance(r, _Hole) for r in level)
                or any((l.s, r.e) in avail for l, r in pairs))
            if (len(pairs) >= 2 and options.batch_merges and not resuming
                    and _level_fits_batched(ctx, pairs)):
                # the level as one batch; an odd trailing region is
                # carried unchanged
                if stop_requested():
                    raise RuntimeError("stop requested via %s after %d/%d "
                                       "merges" % (stop_file, done, total))
                merged = _merge_pairs(ctx, pairs)
                for reg in merged:
                    done += 1
                    log.v("merged [%d,%d): %d/%d" % (reg.s, reg.e, done,
                                                     total))
                level = merged + level[2 * len(pairs):]
            else:
                level, done = merge_level_pairwise(level, done)
            if ckpt is not None:
                # force + drain ahead of the root merge: its children
                # persist before the longest merge starts
                root_next = len(level) == 2
                for reg in level:
                    if not isinstance(reg, _Hole):
                        ckpt.offer(reg, _packed_getter(ctx, reg),
                                   force=root_next)
                if root_next:
                    with phase("checkpoint drain"):
                        ckpt.drain()
        final = level[0]
        assert not isinstance(final, _Hole)
        with phase("final download"):
            bwt = _region_bwt(ctx, final)  # one download per build
        if (rows_out is not None and final.packed is not None
                and sigma <= 256 and bool((final.hist > 0).all())):
            rows_out.append(DeviceRowsHandle(
                final.packed, ctx.bits, n, sigma,
                np.asarray(final.hist, np.int64).copy()))
        ok = True
    finally:
        if ckpt is not None:
            ckpt.finish(ok)
    return bwt, final.samp_pos, final.samp_rank, final.hist
