"""Scaled blockwise BWT construction — the merge engine on the device.

Port of ``bwtb3m_tpu/engine/merge_scaled.py`` (per-pair path, narrow
merges).  The text is cut into fixed blocks of ``max_block_symbols``;
each block's suffixes are sorted by the windowed doubling sort
(``ops/windowsort.py``) and kept as a region: its BWT as packed bytes on
the device, plus

    samp_pos / samp_rank   local ranks at the multiples of the preisa rate
    r_start                local rank of the rotation at the region start
    hist                   symbol histogram of text[s:e]

Regions merge pairwise up a balanced tree (reference: SURVEY.md section
3.1, arXiv:1604.06687): the right region's rank rows are built on the
device, anchored gap chains give the gap histogram (``ops/gapdev.py``,
the CUDA kernel ``csrc/gap_chain.cu``), and the two BWTs are zipped on
the device (``ops/devzip.py``).  Sample ranks update in O(#samples): a
left position p gains R(p) from the chains, a right rank r gains
cnt_le[r].  Completed regions are checkpointed (``engine/checkpoint.py``)
and a build stopped by ``<output>.stop`` or a crash resumes from them.
The BWT crosses to the host once, at the end.

Not ported (``NotImplementedError`` naming the ROADMAP.md item): the wide
path (a merge whose right region reaches (2^24-1)*256 - 2 ranks or whose
left block reaches 2^32 symbols, texts of 2^32 symbols or more, or
``BWTB3M_FORCE_WIDE``; Queue 1 item 6).  Batched levels (item 5) give
the same outputs as the per-pair path, which runs every level here.
The reference's fused and pipelined block sorts, shape buckets and the
uint16 histogram were relay and XLA:TPU workarounds.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from bwtb3m_tpu.util.log import VerboseLog

from ..ops.devzip import (bits_for, cnt_le_at_ranks, device_interleave,
                          gap_cum, rows_from_host_bwt, rows_to_host_bwt,
                          pack_region)
from ..ops.focc_build import build_focc_from_packed
from ..ops.gapdev import GapRunner, cmp_rot
from ..ops.windowsort import block_suffix_order
from ..util.phases import Phases
from .checkpoint import MergeCheckpointer, build_key, load_region_file, \
    pack_host
from .options import BwtOptions

WIDE_ITEM = "ROADMAP.md Queue 1 item 6"
ANCHOR_LOOKBACK = 64      # first anchor walk length, grown x4


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


class _Hole:
    """Placeholder for a tree node covered by a saved ancestor at resume:
    it keeps the level lists aligned and is never computed."""

    def __init__(self, s: int, e: int):
        self.s, self.e = s, e


class _Ctx:
    def __init__(self, text: np.ndarray, sigma: int, rate: int,
                 options: BwtOptions, log: Optional[VerboseLog],
                 lane_bucket: int, device: torch.device, phase: Phases,
                 nthreads: int = 4):
        self.text = np.ascontiguousarray(text, dtype=np.uint8)
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
        with phase("text upload"):
            self.text_dev = torch.from_numpy(self.text).to(device)


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
    """The circular window text[s : s+W] (uint8, on the device)."""
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
    hist = torch.bincount(ctx.text_dev[s:e], minlength=ctx.sigma)[
        :ctx.sigma].cpu().numpy().astype(np.int64)
    return Region(s, e, packed, None, spos, sranks, r_start, hist)


# --------------------------------------------------------------- pair merge

def anchored_lanes(ctx: _Ctx, runner: GapRunner):
    """The chain lanes of a merge: T segments over [s, m) as (starts,
    seeds, lens); lane j walks starts[j] down for lens[j] steps from
    seeds[j] = R(starts[j] + 1), anchored by interval contraction with
    the lookback growing x4 until every interior seed is determined."""
    s, m = runner.s, runner.m
    block_len = m - s
    T = max(1, min(ctx.lane_bucket, block_len // 64 or 1))
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    starts = bounds[1:] - 1
    lens = np.diff(bounds)
    seeds = np.zeros(T, dtype=np.int64)
    seeds[T - 1] = runner.isa_m
    lb = ANCHOR_LOOKBACK
    todo = np.arange(T - 1)
    while len(todo):
        vals, ok = runner.anchor(starts[todo], min(lb, ctx.n))
        seeds[todo[ok]] = vals[ok]
        todo = todo[~ok]
        if len(todo) and lb >= ctx.n:
            raise AssertionError(
                "anchor unresolved at full lookback — equal-rotation "
                "boundary should be impossible for interior anchors")
        lb = min(lb * 4, ctx.n)
        if len(todo):
            ctx.log.v("anchor lookback extended to %d for %d lanes"
                      % (lb, len(todo)))
    return starts, seeds, lens


def _merge_pair(ctx: _Ctx, left: Region, right: Region) -> Region:
    """Merge the adjacent regions [s, m) and [m, e)."""
    s, m, e = left.s, left.e, right.e
    assert right.s == m
    block_len = m - s
    if e - m + 2 > ((1 << 24) - 1) * 256 or m - s >= (1 << 32):
        raise NotImplementedError(
            "merge [%d,%d,%d) needs the wide path, which is not ported "
            "yet: %s" % (s, m, e, WIDE_ITEM))
    phase = ctx.phase
    with phase("rank rows"):
        focc = build_focc_from_packed(_region_packed(ctx, right), e - m,
                                      ctx.sigma, ctx.bits)
    runner = GapRunner(focc, ctx.text_dev, ctx.text, s, m, e,
                       isa_m=right.r_start, first_hist=right.hist,
                       sample_rate=ctx.rate, nthreads=ctx.nthreads,
                       phase=phase)

    with phase("anchors"):
        starts, seeds, lens = anchored_lanes(ctx, runner)
    with phase("chains"):
        runner.run_chains(starts, seeds, lens)
    A, B = m - s, e - m
    with phase("zip"):
        cnt_le = gap_cum(runner.gap)
        total = int(cnt_le[-1])
        assert total == block_len, (total, block_len)
        cnt_right = cnt_le_at_ranks(runner.gap, right.samp_rank, cnt_le)
        # chain self-check: every lane's final R(bounds[j]) must equal the
        # anchored seed of the lane to its left
        fin = runner.final_rs
        if not np.array_equal(fin[1:], seeds[:-1]):
            bad = int(np.flatnonzero(fin[1:] != seeds[:-1])[0])
            raise AssertionError("anchor/chain mismatch at lane %d: %d != %d"
                                 % (bad + 1, fin[bad + 1], seeds[bad]))
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
    return Region(s, e, merged, None, pos, rank,
                  int(left.r_start + runner.final_rs[0]),
                  left.hist + right.hist)


# --------------------------------------------------------------- the tree

def blockwise_bwt_scaled(
    symbols: np.ndarray, sigma: int, options: BwtOptions,
    log: Optional[VerboseLog] = None, sample_rate: int = 1024,
    lane_bucket: int = 1 << 16, device="cpu", phase: Phases = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(bwt uint8, preisa positions, preisa ranks, symbol hist) of the
    circular text ``symbols`` over [0, sigma), every device step on
    ``device``.  ``phase`` (a ``util.phases.Phases``) collects the wall
    time per phase."""
    log = log or VerboseLog(1)
    device = torch.device(device)
    phase = phase or Phases(device)
    text = np.asarray(symbols)
    n = len(text)
    if sigma > 256:
        raise ValueError("scaled merge engine supports sigma <= 256 "
                         "(byte device text); rank-compact the alphabet "
                         "first (engine/api.py does)")
    if n >= 1 << 32 or os.environ.get("BWTB3M_FORCE_WIDE"):
        raise NotImplementedError(
            "the wide merge path (n >= 2^32 or BWTB3M_FORCE_WIDE) is not "
            "ported yet: " + WIDE_ITEM)
    ctx = _Ctx(text, sigma, sample_rate, options, log, lane_bucket, device,
               phase)
    blocks = _plan_blocks_fixed(n, options.max_block_symbols)
    log.v("scaled blockwise engine: %d blocks, rate=%d, lanes<=%d, %s"
          % (len(blocks), sample_rate, lane_bucket, device))
    if options.batch_merges and len(blocks) > 2:
        log.v("batchmerges=1: levels run pair by pair (batched levels are "
              "ROADMAP.md Queue 1 item 5; the outputs are the same)")

    # durable merge-tree checkpointing: resume from the deepest complete
    # saved tree nodes
    ckpt = None
    avail = {}
    if options.checkpoint and options.tmp_prefix and len(blocks) > 1:
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
    total = len(regions) - 1
    done = 0
    level = regions
    ok = False
    try:
        while len(level) > 1:
            nxt: List[object] = []
            i = 0
            while i + 1 < len(level):
                if os.path.exists(stop_file):
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
                    merged = _merge_pair(ctx, l, r)
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
            level = nxt
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
        ok = True
    finally:
        if ckpt is not None:
            ckpt.finish(ok)
    return bwt, final.samp_pos, final.samp_rank, final.hist
