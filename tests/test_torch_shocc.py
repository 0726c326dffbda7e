"""Rank-range-sharded rank rows of the port against the reference's.

The port's ranks are gloo processes on the CPU (``run_ranks``, one spawn
per world size with every job of it inside, under a deadline); the
reference runs on the conftest's virtual CPU mesh, ``make_mesh(D)`` with
the same D, at D = 2, 3 and 4.  Exact equality throughout:

- ``ShardedOccGapRunner`` on ``tests/test_shocc.py``'s merges (2^13
  random symbols over 4 and over 16, samples at 512): the histogram, the
  lanes' final ranks and the samples against the reference's
  ``ShardedOccGapRunner``, on sector and bit-plane rows (sigma 4) and
  byte rows (sigma 16), on every rank;
- ``blockwise_bwt_scaled(mesh=)`` on ``__graft_entry__.py``'s five-block
  case with ``BWTB3M_SHARD_OCC=1`` (the batched level's lanes sharded,
  every pair merge's rows sharded by rank range) and with a budget of one
  byte (``BWTB3M_DEV_HBM`` and ``BWTB3M_BATCH_HBM``: the auto dispatch
  shards every merge's rows and runs no batched level): (bwt, positions,
  ranks, hist) against the reference's builds under the same variables.

Also, without ranks: the rows a rank keeps, and the refusal of wide and
wavelet rows.
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
from bwtb3m_tpu.parallel.shocc import \
    ShardedOccGapRunner as JaxShardedOccGapRunner
from bwtb3m_tpu_torch.ops import wavelet_rows as wr
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from bwtb3m_tpu_torch.parallel import dist, dryrun
from bwtb3m_tpu_torch.parallel.mesh import Mesh
from bwtb3m_tpu_torch.parallel.shocc import shard_focc_rows

DEADLINE = 150.0
RATE = 512
ROWS = [(4, "sector"), (4, "bitplane"), (16, "bytes")]
ENVS = [{"BWTB3M_SHARD_OCC": "1"},
        {"BWTB3M_DEV_HBM": "1", "BWTB3M_BATCH_HBM": "1"}]


@functools.lru_cache(maxsize=None)
def _merge(sigma):
    """test_shocc.py's merge: (text, m, n, right BWT, isa_m)."""
    rng = np.random.default_rng(31)
    n = 1 << 13
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, _isa, _ = jax_suffix_array(text.astype(np.int32), sigma)
    sa = np.asarray(sa)
    m = n // 2
    sel = sa[sa >= m]
    return text, m, n, text[(sel - 1) % n], int(np.flatnonzero(sel == m)[0])


def _scaled_text(D):
    n = D * 4096 + 37
    return np.random.default_rng(200 + D).integers(0, 4, n, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _port(D):
    """Every rank's results of one spawn of D ranks: the occ-sharded
    merge on each row family, then the two scaled builds."""
    calls = []
    for sigma, layout in ROWS:
        text, m, n, right_bwt, isa_m = _merge(sigma)
        calls.append(("merge_case", (text, sigma, 0, m, n, right_bwt, isa_m,
                                     16 * D, RATE, "occ", layout)))
    st = _scaled_text(D)
    calls.append(("scaled_cases", (st, 4, len(st) // 5 + 1, RATE, 16 * D,
                                   ENVS)))
    return dist.run_ranks(dryrun.run_jobs, D, (calls,), device="cpu",
                          timeout=DEADLINE)


@pytest.mark.parametrize("rows", range(len(ROWS)),
                         ids=["%s%d" % (lay, s) for s, lay in ROWS])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_sharded_occ_runner_matches_reference(D, rows):
    sigma, _layout = ROWS[rows]
    text, m, n, right_bwt, isa_m = _merge(sigma)
    T = 16 * D           # the port's plan: min(lane bucket, m // 64) lanes
    run = DeviceGapRunner(
        build_focc(upload_bwt(right_bwt, sigma), sigma),
        build_text_rows(text, sigma), text, 0, m, n, isa_m,
        np.bincount(text[m:], minlength=sigma).astype(np.int64),
        lane_bucket=T, sample_rate=RATE)
    sh = JaxShardedOccGapRunner(jax_make_mesh(D), run)
    bounds = np.linspace(0, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = np.zeros(T, np.int64)
    seeds[T - 1] = isa_m
    vals, ok = sh.anchor(starts[:T - 1], 256)
    assert ok.all()
    seeds[:T - 1] = vals
    gap = sh.run_chains(starts, seeds, lens)
    want_pos, want_val = run.harvest_samples()
    for rank_results in _port(D):
        got_gap, final, hpos, hval = rank_results[rows]["result"]
        np.testing.assert_array_equal(got_gap, gap)
        np.testing.assert_array_equal(final, run.final_rs)
        np.testing.assert_array_equal(hpos, want_pos)
        np.testing.assert_array_equal(hval, want_val)
    assert gap.sum() == m


@pytest.mark.parametrize("env", [0, 1], ids=["forced", "auto"])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_occ_sharded_scaled_build_matches_reference(D, env, monkeypatch):
    text = _scaled_text(D)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    opts = JaxOptions(input_path="<mem>", output_filename=os.devnull,
                      max_block_symbols=len(text) // 5 + 1, verbose=0)
    want = jax_blockwise_bwt_scaled(text, 4, opts, sample_rate=RATE,
                                    lane_bucket=16 * D,
                                    mesh=jax_make_mesh(D))
    for rank_results in _port(D):
        got, msgs, _walls = rank_results[len(ROWS)]["result"][env]
        # forced: the batched level's lanes, then every pair merge by rank
        # range; auto from a one-byte budget: no batched level
        assert any("batched level" in s for s in msgs) == (env == 0), msgs
        assert sum("by rank range" in s for s in msgs) == (2 if env == 0
                                                          else 5), msgs
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("layout", ["sector", "bitplane", "bytes"])
def test_shard_rows_keep_whole_rows_with_global_counts(layout):
    rng = np.random.default_rng(4)
    bwt = rng.integers(0, 4, 3000).astype(np.uint8)
    focc = build_focc_host(bwt, 4, "cpu", layout=layout)
    nrows = focc.rows.shape[0]
    got = []
    for r in range(3):
        local, first = shard_focc_rows(
            Mesh(r, 3, torch.device("cpu"), "gloo"), focc)
        rps = local.rows.shape[0]
        assert rps == -(-nrows // 3) and first == r * rps
        assert local.n == rps << focc.SHIFT
        got.append(local.rows[:max(0, min(rps, nrows - first))])
    assert torch.equal(torch.cat(got), focc.rows)


def test_wide_and_wavelet_rows_are_refused():
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo")
    bwt = np.arange(600, dtype=np.uint8) % 4
    with pytest.raises(ValueError, match="WideOcc"):
        shard_focc_rows(mesh, build_focc_host(bwt, 4, "cpu", wide=True))
    rows = wr.build_wavelet(torch.from_numpy(
        (np.arange(600) % 300).astype(np.int16)), 300)
    with pytest.raises(ValueError, match="WaveletRows"):
        shard_focc_rows(mesh, rows)
