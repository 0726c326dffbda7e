"""Multi-rank checks of the sharded paths, and the jobs they run.

``dryrun_multichip(world, device)`` is the counterpart of the reference's
``__graft_entry__.py::dryrun_multichip``: through ``run_ranks`` it runs
the same five checks at the same sizes, each against the single-device
path on one rank:

1. ``sharded_bwt`` of ``world`` x 2^20 random symbols (sigma 4);
2. a ragged length, ``world`` x 256 + 13 (the pad slots);
3. the lane-sharded chains of one pair merge (``ShardedGapRunner``) of a
   ``world`` x 2,048-symbol text against the single runner;
4. ``blockwise_bwt_scaled(mesh=)`` over five-odd blocks (a batched level
   with its lanes sharded, then pair merges) against the single-device
   build and the doubling sort;
5. the same build with a budget of one byte (``BWTB3M_DEV_HBM`` and
   ``BWTB3M_BATCH_HBM``): the auto dispatch takes the rank-range-sharded
   rows for every merge.

Every rank also reports the modules it imported: none of JAX or of the
reference package.  The functions below run in the ranks (``run_ranks``
takes only this package's functions); the tests and ``chip_smoke.py``
start them too.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from ..ops.devzip import bits_for, rows_from_host_bwt
from ..ops.gapbatch import BatchedGapRunner, word_values
from .dist import run_ranks
from .doubling import sharded_bwt
from .merge import ShardedGapRunner
from .shocc import ShardedOccGapRunner
from ..util.log import VerboseLog

REFERENCE = ("jax", "jaxlib", "bwtb3m_tpu")


def reference_modules() -> list:
    """Modules of JAX or of the reference package this process holds."""
    return sorted(m for m in sys.modules if m.split(".")[0] in REFERENCE)


@contextlib.contextmanager
def _environ(env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------------------------------ jobs

def sharded_bwt_cases(mesh, cases):
    """``sharded_bwt`` of each (text, sigma): rank 0 returns the list of
    (sa, rank, bwt), the other ranks ``reference_modules()``."""
    out = [sharded_bwt(text, sigma, mesh) for text, sigma in cases]
    return out if mesh.rank == 0 else reference_modules()


def merge_case(mesh, text, sigma, s, m, e, right_bwt, r_start, lane_bucket,
               rate, mode, layout="auto"):
    """One pair merge (s, m, e) as a ``BatchedGapRunner`` of one merge on
    the mesh's device: ``mode`` "single" (no mesh), "lanes"
    (``ShardedGapRunner``) or "occ" (``ShardedOccGapRunner``).  Every
    rank returns (histogram int64 [e - m + 1], final ranks, sample
    positions, sample values)."""
    dev = mesh.device
    run = BatchedGapRunner(
        torch.from_numpy(np.ascontiguousarray(text)).to(dev), text, sigma,
        [(s, m, e, r_start, np.bincount(text[m:e], minlength=sigma))],
        [rows_from_host_bwt(right_bwt, sigma, dev)], bits_for(sigma),
        lane_bucket=lane_bucket, sample_rate=rate, layout=layout)
    if mode == "lanes":
        ShardedGapRunner(mesh, run).compute()
    else:
        if mode == "occ":
            ShardedOccGapRunner(mesh, run)
        run.compute()
    view = run.view(0)
    hpos, hval = view.harvest_samples()
    return (word_values(run.focc, view.gap).cpu().numpy(),
            np.asarray(view.final_rs), hpos, hval)


class _Messages(VerboseLog):
    """A log that keeps its ``-v`` messages."""

    def __init__(self):
        super().__init__(0)
        self.messages = []

    def v(self, msg: str, level: int = 1) -> None:
        self.messages.append(msg)


def scaled_cases(mesh, text, sigma, max_block_symbols, sample_rate,
                 lane_bucket, envs):
    """``blockwise_bwt_scaled(mesh=)`` of the text once per environment
    in ``envs`` (dicts of variables set around the build): per build
    ((bwt, positions, ranks, hist), the log's messages, the build's wall
    seconds per phase); every rank's result is the same."""
    from ..engine.merge_scaled import blockwise_bwt_scaled
    from ..engine.options import BwtOptions
    from ..util.phases import Phases
    opts = BwtOptions(input_path="<mem>", output_filename=os.devnull,
                      max_block_symbols=max_block_symbols, verbose=0)
    out = []
    for env in envs:
        log = _Messages()
        phase = Phases(mesh.device)
        with _environ(env):
            res = blockwise_bwt_scaled(
                text, sigma, opts, log, sample_rate=sample_rate,
                lane_bucket=lane_bucket, mesh=mesh, phase=phase)
        out.append((res, log.messages, dict(phase.wall)))
    return out


def level_on_lane_parts(mesh, text, sigma, max_block_symbols, sample_rate,
                        lane_bucket, every, check_rank):
    """The first level of ``blockwise_bwt_scaled``'s tree as the engine
    builds it (block sorts, then the runner of its pairs) with its lanes
    sharded over the mesh; then, on rank ``check_rank`` only,
    ``kernel_on_lane_part`` of every ``every``-th lane of its part.
    Returns (lanes of the level, that rank's comparison or None)."""
    from ..engine import merge_scaled as ms
    from ..engine.options import BwtOptions
    from ..util.phases import Phases
    opts = BwtOptions(input_path="<mem>", output_filename=os.devnull,
                      max_block_symbols=max_block_symbols, verbose=0)
    ctx = ms._Ctx(np.asarray(text), sigma, sample_rate, opts, None,
                  lane_bucket, mesh.device, Phases(mesh.device), mesh=mesh)
    blocks = ms._plan_blocks_fixed(len(text), max_block_symbols)
    regions = [ms._sort_block(ctx, s, e) for s, e in blocks]
    runner = ms._level_runner(ctx, [(regions[i], regions[i + 1])
                                    for i in range(0, len(regions) - 1, 2)])
    runner.compute(ms.ANCHOR_LOOKBACK)
    lanes = sum(sp.T for sp in runner.specs)
    if mesh.rank != check_rank:
        return lanes, None
    return lanes, kernel_on_lane_part(runner, every)


def imported_reference(mesh) -> list:
    """The job form of ``reference_modules``."""
    return reference_modules()


def exchange_seconds(mesh, n: int, reps: int):
    """Seconds of one ``exchange`` of ``n`` int64 between the partners of
    an odd-even round (rank 2k with 2k + 1; a last odd rank is idle):
    the mean of ``reps``, after one untimed.  (seconds, bytes sent)."""
    from .blocksort import _partner_table, exchange
    part = _partner_table(mesh.world, 0)
    x = torch.arange(n, dtype=torch.int64, device=mesh.device)
    for rep in range(reps + 1):
        if rep == 1:
            t0 = time.monotonic()
        exchange(mesh, [x], list(enumerate(part)))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
    return (time.monotonic() - t0) / reps, 8 * n


def run_jobs(mesh, calls):
    """Each (name, args) of ``calls`` in turn: this module's job ``name``
    on the mesh.  Per job a dict: ``result``; ``launches``, those it made
    on this rank as ``ops/gapbatch.py::LAUNCHES`` and
    ``ops/lf_walk.py::LAUNCHES`` count them; ``start`` (``time.time()``
    at its start) and ``seconds`` (its wall time, ended by a device
    sync)."""
    from ..ops import gapbatch as gb
    from ..ops import lf_walk as lw
    jobs = {f.__name__: f for f in (sharded_bwt_cases, merge_case,
                                    scaled_cases, compute_bwt_job,
                                    level_on_lane_parts, imported_reference,
                                    exchange_seconds)}
    out = []
    for name, args in calls:
        gb.reset_launch_counts()
        lw.reset_launch_counts()
        start, t0 = time.time(), time.monotonic()
        res = jobs[name](mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out.append({"result": res, "seconds": time.monotonic() - t0,
                    "start": start,
                    "launches": {"gap_chain": dict(gb.LAUNCHES),
                                 "lf_walk": dict(lw.LAUNCHES)}})
    return out


def compute_bwt_job(mesh, options: dict):
    """``compute_bwt(BwtOptions(**options))`` in the group: the result's
    meta (rank 0 writes the files) and ``reference_modules()``."""
    from ..engine import BwtOptions, compute_bwt
    res = compute_bwt(BwtOptions(**options))
    return res.meta, reference_modules()


def kernel_on_lane_part(runner, every: int = 1):
    """After a lane-sharded ``runner.compute()``: the chain kernel
    (``chain_walk_mk``) against its plain version (``gap_chain_mk_plain``)
    on every ``every``-th lane of this rank's part, each into a fresh
    histogram and samples.  Returns (lanes compared, launches of the
    kernel, whether final ranks, histograms and samples are equal)."""
    from ..ops import gapbatch as gb
    kid = np.concatenate([np.full(sp.T, sp.k) for sp in runner.specs])
    starts = np.concatenate([sp.starts for sp in runner.specs])
    lens = np.concatenate([sp.lens for sp in runner.specs])
    seeds = np.concatenate([sp.seeds for sp in runner.specs])
    pick = np.arange(len(kid))[runner._part(len(kid))][::every]
    lanes = runner._lanes(kid[pick], starts[pick], seeds[pick], lens[pick])
    outs = []
    before = gb.LAUNCHES["chain"]
    for walk in (gb.chain_walk_mk, gb.gap_chain_mk_plain):
        gap = torch.zeros_like(runner.gap)
        samp = torch.full_like(runner._samp, -1)
        r = walk(runner.focc, runner.text_dev, runner.gt_dev,
                 runner.c_first, runner.table, *lanes, gap, samp,
                 runner.sample_rate)
        outs.append((r, gap, samp))
    (ra, ga, sa_), (rb, gbp, sb) = outs
    same = (torch.equal(ra, rb) and torch.equal(ga, gbp)
            and torch.equal(sa_, sb))
    return len(pick), gb.LAUNCHES["chain"] - before, same


# ---------------------------------------------------------------- dryrun

def _dryrun_rank(mesh):
    """The five checks of the module docstring on one rank: rank 0
    compares with the single-device path and returns the sizes."""
    from ..engine.merge_scaled import blockwise_bwt_scaled
    from ..engine.options import BwtOptions
    from ..ops.doubling import suffix_array
    D, dev = mesh.world, mesh.device
    sigma = 4
    rng = np.random.default_rng(1)
    lead = mesh.rank == 0

    # 1-2) sharded sort, a length of whole shards and a ragged one
    n_big, n_rag = D << 20, D * 256 + 13
    for n in (n_big, n_rag):
        text = rng.integers(0, sigma, n, dtype=np.int32)
        sa, _rank, bwt = sharded_bwt(text, sigma, mesh)
        if lead:
            sa1, _isa, bwt1 = suffix_array(text, sigma, dev)
            assert np.array_equal(sa, sa1), "sharded SA != single SA (%d)" % n
            assert np.array_equal(bwt, bwt1), "sharded BWT mismatch (%d)" % n

    # 3) lane-sharded chains of one pair merge against the single runner
    n = D * 2048
    text = rng.integers(0, sigma, n, dtype=np.uint8)
    sa2, _isa, _b = suffix_array(text, sigma, dev)
    m = n // 2
    sel = sa2[sa2 >= m]
    args = (text, sigma, 0, m, n, text[(sel - 1) % n],
            int(np.flatnonzero(sel == m)[0]), 8 * D, 512)
    got = merge_case(mesh, *args, "lanes")
    if lead:
        want = merge_case(mesh, *args, "single")
        for a, b in zip(got, want):
            assert np.array_equal(a, b), "lane-sharded merge mismatch"
        assert got[0].sum() == m

    # 4-5) the scaled engine under the mesh; then a one-byte budget
    n_e2e = D * 4096 + 37
    text = rng.integers(0, sigma, n_e2e, dtype=np.uint8)
    lb = 16 * D
    envs = [{}, {"BWTB3M_DEV_HBM": "1", "BWTB3M_BATCH_HBM": "1"}]
    ((bwt_m, pos_m, rank_m, hist_m), _, _), \
        ((bwt_a, pos_a, rank_a, _h), msgs, _) = scaled_cases(
            mesh, text, sigma, n_e2e // 5 + 1, 512, lb, envs)
    assert any("sharded by rank range" in m for m in msgs), msgs
    if lead:
        opts = BwtOptions(input_path="<mem>", output_filename=os.devnull,
                          max_block_symbols=n_e2e // 5 + 1, verbose=0)
        bwt_1, pos_1, rank_1, hist_1 = blockwise_bwt_scaled(
            text, sigma, opts, VerboseLog(0), sample_rate=512,
            lane_bucket=lb, device=dev)
        _sa, _isa, bwt_o = suffix_array(text, sigma, dev)
        assert np.array_equal(bwt_m, bwt_1), "mesh scaled BWT != single"
        assert np.array_equal(bwt_m, bwt_o.astype(np.uint8)), \
            "mesh scaled BWT != doubling sort"
        assert np.array_equal(pos_m, pos_1) and np.array_equal(
            rank_m, rank_1), "mesh scaled samples mismatch"
        assert np.array_equal(hist_m, hist_1), "mesh scaled hist mismatch"
        assert np.array_equal(bwt_a, bwt_1) and np.array_equal(
            pos_a, pos_1) and np.array_equal(rank_a, rank_1), \
            "auto occ-sharded build mismatch"
    return (n_big, n_rag, n, n_e2e), reference_modules()


def dryrun_multichip(world: int, device="cuda", timeout: float = 900.0
                     ) -> str:
    """The five checks on ``world`` ranks (module docstring); raises on a
    mismatch, a failed rank or a passed deadline.  Returns the summary
    line."""
    results = run_ranks(_dryrun_rank, world, device=device, timeout=timeout)
    loaded = sorted({m for _sizes, mods in results for m in mods})
    if loaded:
        raise AssertionError("ranks imported %s" % loaded)
    n_big, n_rag, n, n_e2e = results[0][0]
    return ("dryrun_multichip ok: %d ranks on %s, n=%d (+ragged n=%d, "
            "+lane-sharded merge chains n=%d, +scaled merge-tree engine "
            "n=%d incl. a lane-sharded batched level + auto rank-range "
            "sharding), bit-identical" % (world, device, n_big, n_rag, n,
                                          n_e2e))
