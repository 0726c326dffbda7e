"""Lane-sharded merges of the port against the reference's, on 2-4 ranks.

The port's ranks are gloo processes on the CPU (``run_ranks``, one spawn
per world size with every job of it inside, under a deadline); the
reference runs on the conftest's virtual CPU mesh, ``make_mesh(D)`` with
the same D.  Exact equality throughout:

- ``ShardedGapRunner`` on ``tests/test_sharded_merge.py``'s merge (2^14
  random symbols over 4, the right half merged into the left; 16 D lanes,
  samples at 512): the histogram, the lanes' final ranks and the samples
  against the reference's ``ShardedGapRunner`` and single runner, and
  against the port's single runner;
- ``blockwise_bwt_scaled(mesh=)`` on ``__graft_entry__.py``'s five-block
  case (D x 4,096 + 37 symbols, blocks of a fifth, lanes 16 D, samples
  at 512): a batched level with its lanes cut over the ranks, then pair
  merges; (bwt, positions, ranks, hist) against the reference's mesh
  build, on every rank.

Also the job that holds the chain kernel to its plain version on one
rank's lanes (``chip_smoke.py`` runs it on the card), and, without
ranks: the lane parts, and the runner's refusal of a lane bucket that
does not divide by the world size.
"""

import functools
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# the ranks share this process's intra-op threads: one each
torch.set_num_threads(1)

from bwtb3m_tpu.engine.merge_scaled import \
    blockwise_bwt_scaled as jax_blockwise_bwt_scaled
from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.ops.focc import build_focc
from bwtb3m_tpu.ops.gapdev import DeviceGapRunner, build_text_rows, upload_bwt
from bwtb3m_tpu.parallel import make_mesh as jax_make_mesh
from bwtb3m_tpu.parallel.merge import ShardedGapRunner as JaxShardedGapRunner
from bwtb3m_tpu_torch.ops.devzip import rows_from_host_bwt
from bwtb3m_tpu_torch.ops.gapbatch import BatchedGapRunner
from bwtb3m_tpu_torch.parallel import dist, dryrun
from bwtb3m_tpu_torch.parallel.mesh import Mesh

DEADLINE = 150.0
RATE = 512


@functools.lru_cache(maxsize=None)
def _merge():
    """test_sharded_merge.py's merge: (text, m, n, right BWT, isa_m)."""
    rng = np.random.default_rng(21)
    n = 1 << 14
    text = rng.integers(0, 4, n).astype(np.uint8)
    sa, _isa, _ = jax_suffix_array(text.astype(np.int32), 4)
    sa = np.asarray(sa)
    m = n // 2
    sel = sa[sa >= m]
    return text, m, n, text[(sel - 1) % n], int(np.flatnonzero(sel == m)[0])


def _scaled_text(D):
    n = D * 4096 + 37
    return np.random.default_rng(100 + D).integers(0, 4, n, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _port(D):
    """Every rank's results of one spawn of D ranks: the lane-sharded and
    the single runner on the merge, then the lane-sharded scaled build."""
    text, m, n, right_bwt, isa_m = _merge()
    merge = (text, 4, 0, m, n, right_bwt, isa_m, 16 * D, RATE)
    st = _scaled_text(D)
    calls = [("merge_case", merge + ("lanes",)),
             ("merge_case", merge + ("single",)),
             ("scaled_cases", (st, 4, len(st) // 5 + 1, RATE, 16 * D,
                               [{}])),
             ("level_on_lane_parts", (st, 4, len(st) // 5 + 1, RATE, 16 * D,
                                      3, D - 1))]
    return dist.run_ranks(dryrun.run_jobs, D, (calls,), device="cpu",
                          timeout=DEADLINE)


@pytest.mark.parametrize("D", [2, 3, 4])
def test_sharded_gap_runner_matches_reference(D):
    text, m, n, right_bwt, isa_m = _merge()
    hist = np.bincount(text[m:], minlength=4).astype(np.int64)
    focc = build_focc(upload_bwt(right_bwt, 4), 4)
    trows = build_text_rows(text)
    T = 16 * D           # the port's plan: min(lane bucket, m // 64) lanes

    def mk():
        return DeviceGapRunner(focc, trows, text, 0, m, n, isa_m, hist,
                               lane_bucket=T, sample_rate=RATE)

    bounds = np.linspace(0, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = np.zeros(T, np.int64)
    seeds[T - 1] = isa_m
    r1 = mk()
    vals, ok = r1.anchor(starts[:T - 1], 256)
    assert ok.all()
    seeds[:T - 1] = vals
    r1.run_chains(starts, seeds, lens)
    gap_single = np.asarray(r1.gap, np.int64).reshape(-1)[:m + 1]
    r2 = mk()
    gap_mesh = JaxShardedGapRunner(jax_make_mesh(D), r2).run_chains(
        starts, seeds, lens)
    np.testing.assert_array_equal(gap_mesh, gap_single)
    want_pos, want_val = r2.harvest_samples()
    for rank_results in _port(D):
        for gap, final, hpos, hval in [r["result"] for r in rank_results[:2]]:
            np.testing.assert_array_equal(gap, gap_mesh)
            np.testing.assert_array_equal(final, r2.final_rs)
            np.testing.assert_array_equal(hpos, want_pos)
            np.testing.assert_array_equal(hval, want_val)
    assert gap_mesh.sum() == m


@pytest.mark.parametrize("D", [2, 3, 4])
def test_lane_sharded_scaled_build_matches_reference(D):
    text = _scaled_text(D)
    opts = JaxOptions(input_path="<mem>", output_filename=os.devnull,
                      max_block_symbols=len(text) // 5 + 1, verbose=0)
    want = jax_blockwise_bwt_scaled(text, 4, opts, sample_rate=RATE,
                                    lane_bucket=16 * D,
                                    mesh=jax_make_mesh(D))
    for rank_results in _port(D):
        (got, msgs, _walls), = rank_results[2]["result"]
        assert any("batched level: 3 merges" in s for s in msgs), msgs
        assert not any("rank range" in s for s in msgs), msgs
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("D", [2, 3, 4])
def test_level_lane_part_check_runs_on_one_rank(D):
    """The job ``chip_smoke.py`` runs to hold the chain kernel to its
    plain version on one rank's lanes of a lane-sharded level (on the CPU
    the wrapper runs the plain version, so both sides agree trivially
    here; the job's plumbing is what is checked)."""
    results = [r[3]["result"] for r in _port(D)]
    lanes = {n for n, _check in results}
    assert len(lanes) == 1 and lanes.pop() > D
    for rank, (n, check) in enumerate(results):
        if rank != D - 1:
            assert check is None
        else:
            compared, launches, same = check
            assert compared == len(range(0, -(-n // D), 3)) or \
                compared == len(range(0, n - (D - 1) * -(-n // D), 3))
            assert launches == 0 and same


def test_lane_parts_cover_the_lanes_in_order():
    text = np.zeros(1024, np.uint8)
    text[::3] = 1
    run = BatchedGapRunner(
        torch.from_numpy(text), text, 2,
        [(0, 512, 1024, 0, np.bincount(text[512:], minlength=2))],
        [rows_from_host_bwt(text[512:], 2, "cpu")], 4, lane_bucket=12)
    for lanes in (10, 2, 0, 12):
        parts = []
        for r in range(3):
            run.mesh = Mesh(r, 3, torch.device("cpu"), "gloo")
            parts.append(run._part(lanes))
        assert [p.stop - p.start for p in parts][:1] == [-(-lanes // 3)
                                                         if lanes else 0]
        assert np.array_equal(np.concatenate(
            [np.arange(lanes)[p] for p in parts]), np.arange(lanes))
    with pytest.raises(ValueError, match="does not divide by 3 ranks"):
        BatchedGapRunner(
            torch.from_numpy(text), text, 2,
            [(0, 512, 1024, 0, np.bincount(text[512:], minlength=2))],
            [rows_from_host_bwt(text[512:], 2, "cpu")], 4, lane_bucket=16,
            mesh=Mesh(0, 3, torch.device("cpu"), "gloo"))


@pytest.mark.parametrize("walker", ["runner", "rank range"])
def test_runner_is_freed_without_the_cyclic_collector(walker):
    """A level's runner (its rank rows and histogram on the device) goes
    when the engine drops it, with or without a rank-range walker: no
    reference cycle holds it until the cyclic collector runs (the peak
    of the next level would count it)."""
    import gc
    import weakref
    from bwtb3m_tpu_torch.parallel.shocc import ShardedOccGapRunner
    text = np.zeros(1024, np.uint8)
    text[::3] = 1
    run = BatchedGapRunner(
        torch.from_numpy(text), text, 2,
        [(0, 512, 1024, 0, np.bincount(text[512:], minlength=2))],
        [rows_from_host_bwt(text[512:], 2, "cpu")], 4, lane_bucket=12)
    if walker == "rank range":
        ShardedOccGapRunner(Mesh(0, 1, torch.device("cpu"), "gloo"), run)
        assert run.walks is not run
    else:
        assert run.walks is run
    ref = weakref.ref(run)
    gc.disable()
    try:
        del run
        assert ref() is None
    finally:
        gc.enable()
