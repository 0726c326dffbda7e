"""Rank-range-sharded rank rows: one pair merge's state over the ranks.

Port of ``bwtb3m_tpu/parallel/shocc.py``.  The lane-sharded path
(``parallel/merge.py``) replicates the right region's rank rows on every
rank.  Here the rows are cut by rank range instead: rank d keeps rows
[d rps, (d+1) rps) (``shard_focc_rows``; sector, bit-plane or byte rows,
``ops/focc_build.py``, cut only at whole rows).  Each row keeps its
global occ counts, so an owned lane's rank from the slice is its global
rank.  A rank query goes to every rank: each answers the lanes it owns
from its own rows with the family's plain ``rank`` (``ops/focc.py``,
``ops/focc_bp.py``), zeroes the others, and one ``all_reduce(SUM)`` per
step assembles the answer (``_rank_sharded``).  What follows the reduce,
the step's arithmetic (the reference's ``_chain_step_sh``), is the same
on every rank: it is ``ops/gapbatch.py::gap_chain_mk_plain`` with its
rank query routed here.  So the lanes stay replicated: every rank holds
every lane's rank, its final ranks and its samples.

The gap histogram, the other per-merge buffer, is cut by the same rank
ranges: each rank records only the cells it owns; cells of earlier
ranks' rows are out of its range, not wrapped (the reference remaps them
explicitly, as ``.at[]`` wraps negative indices before dropping).  The
engine's zip then needs the whole histogram, so ``run_chains`` ends with
one ``all_gather`` of the parts.  The histogram is int32 (the port has no
uint16 histogram), so the reference's rerun with an int32 histogram after
a wrapped u16 checksum (``engine/merge_scaled.py:724-732``) has no
counterpart.

A collective at every step breaks the dependent walk, so this path is
not one kernel launch: each step is torch on the rank's own rows (a fused
one-step kernel over a row range is queued in ROADMAP.md).  Wide rows and
wavelet rows are refused, as in the reference (its legacy engine takes
sigma > 256); such merges take the lane-sharded path.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref

import numpy as np
import torch

from ..ops.focc import rank
from ..ops.gapbatch import gap_chain_mk_plain
from ..ops.wavelet_rows import WaveletRows
from ..ops.wideocc import WideOcc
from .mesh import Mesh, all_gather, all_reduce


def shard_focc_rows(mesh: Mesh, focc):
    """(this rank's rows as a structure of the same family, the global
    index of its first row): rows [rank rps, (rank+1) rps) with rps =
    ceil(rows / world), padded with zero rows past the end (queries never
    read them).  Its ``n`` is the slice's rank space."""
    if isinstance(focc, (WideOcc, WaveletRows)):
        raise ValueError("rank-range sharding takes sector, bit-plane or "
                         "byte rows, not %s" % type(focc).__name__)
    rows = focc.rows
    rps = -(-rows.shape[0] // mesh.world)
    first = mesh.rank * rps
    local = rows[first:first + rps]
    if local.shape[0] < rps:
        local = torch.cat([local, torch.zeros(
            (rps - local.shape[0], rows.shape[1]), dtype=rows.dtype,
            device=rows.device)])
    return dataclasses.replace(focc, rows=local.contiguous(),
                               n=rps << focc.SHIFT), first


def _rank_sharded(mesh: Mesh, local, first: int, c: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """rank(c, r) with the rows sharded: this rank's answer for the lanes
    it owns, zero for the others, summed over the ranks."""
    b = r >> local.SHIFT
    own = (b >= first) & (b < first + local.rows.shape[0])
    r_loc = torch.where(own, r - (first << local.SHIFT), 0)
    rk = torch.where(own, rank(local, c, r_loc), 0)
    return all_reduce(mesh, rk, "sum")


class ShardedOccGapRunner:
    """The walks of a ``BatchedGapRunner`` of one merge with its rank rows
    and histogram sharded by rank range: it takes the runner's place as
    ``runner.walks``, so ``runner.compute()`` and everything downstream
    (views, checksum, samples, the zip) run unchanged."""

    def __init__(self, mesh: Mesh, runner):
        self.mesh = mesh
        # weak: the runner holds this walker, and a cycle would keep the
        # merge's device tensors until the cyclic collector ran
        self.r = weakref.proxy(runner)
        self.local, self.first = shard_focc_rows(mesh, runner.focc)
        runner.walks = self

    def _walk(self, kid, starts, seeds, lens, **record) -> torch.Tensor:
        r = self.r
        kd, st, sd, ln = r._lanes(kid, starts, seeds, lens)
        return gap_chain_mk_plain(r.focc, r.text_dev, r.gt_dev, r.c_first,
                                  r.table, kd, st, sd, ln,
                                  rank_fn=functools.partial(
                                      _rank_sharded, self.mesh, self.local,
                                      self.first), **record)

    def anchor(self, kid, starts, seeds, lens) -> np.ndarray:
        """The anchor walk of every lane: final global ranks."""
        return self._walk(kid, starts, seeds, lens).cpu().numpy()

    def anchor_bounds(self, kid, starts, lens, lo_seeds, hi_seeds):
        """The anchor walks from both bounds as one walk of twice the
        lanes: half the steps, so half the collectives."""
        both = self.anchor(np.r_[kid, kid], np.r_[starts, starts],
                           np.r_[lo_seeds, hi_seeds], np.r_[lens, lens])
        return both[:len(kid)], both[len(kid):]

    def run_chains(self, kid, starts, seeds, lens) -> np.ndarray:
        """The recording walk of every lane into this rank's cells, then
        the whole histogram on every rank: final global ranks.  The walk's
        host time (its steps' collectives included) goes to
        ``runner.chain_ms``."""
        r = self.r
        cells = self.local.rows.shape[0] << self.local.SHIFT
        dev = r.text_dev.device
        local_gap = torch.zeros(cells, dtype=torch.int32, device=dev)
        r._samp = torch.full((r._nsamp,), -1, dtype=torch.int32, device=dev)
        t0 = time.monotonic()
        final = self._walk(kid, starts, seeds, lens, gap=local_gap,
                           samp=r._samp, rate=r.sample_rate,
                           gap_base=self.first << self.local.SHIFT)
        r.chain_ms = (time.monotonic() - t0) * 1e3
        r.gap = all_gather(self.mesh, local_gap).reshape(-1)[
            :r.focc.n + 1].contiguous()
        r.chain_steps = int(np.asarray(lens).sum())
        return final.cpu().numpy()
