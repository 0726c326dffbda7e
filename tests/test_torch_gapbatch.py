"""The port's batched merge levels against the reference's.

Mirrors ``tests/test_gapbatch.py`` case for case: random (n, blocks,
rate) texts against the doubling sort, batched = per-pair, sigma 256, the
budget gate falling back to pairs, periodic ties; in place of the
reference's uint16-wrap case (the port's cells are int32) a highly
repetitive text whose cells pass 65,535.  Per merge, against
``bwtb3m_tpu.ops.gapbatch.BatchedGapRunner`` on the same merges: the
final ranks, the expanded gap histogram and the harvested samples; the
reference's level inputs carried over by ``batched_inputs_from_jax`` give
the same chain in ``gap_chain_mk_plain``.  The concatenated rank rows
equal each region's own rows at its offset on every layout, and a level
of one merge (the engine's single pair merge) gives the R of the sort.
All comparisons are of integers: tolerance 0.  On the CPU the walks run
their plain versions.
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.ops.gapbatch import BatchedGapRunner as JaxBatchedRunner
from bwtb3m_tpu.ops.gapdev import build_text_rows
from bwtb3m_tpu_torch.engine.merge_scaled import blockwise_bwt_scaled
from bwtb3m_tpu_torch.engine.options import BwtOptions
from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
from bwtb3m_tpu_torch.ops.focc_build import (build_focc_concat,
                                             build_focc_from_packed,
                                             focc_from_jax)
from bwtb3m_tpu_torch.ops.gapbatch import (BatchedGapRunner, MERGE_WORDS,
                                           batched_inputs_from_jax,
                                           from_u32_bits,
                                           gap_chain_mk_plain, u32_bits)
from bwtb3m_tpu_torch.util.log import VerboseLog


def _opts(n, nb, tmp_path, **kw):
    return BwtOptions(input_path="x", device="cpu",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=-(-n // nb), **kw)


def _log_probe(msgs):
    log = VerboseLog(0)
    log.v = lambda *a: msgs.append(a[0] if a else "")
    return log


def _check_against_doubling(text, sigma, out):
    bwt_b, spos, srank, hist = out
    _sa, isa, bwt_d = jax_suffix_array(text.astype(np.int32), sigma)
    np.testing.assert_array_equal(bwt_b.astype(np.int64),
                                  np.asarray(bwt_d, np.int64))
    np.testing.assert_array_equal(srank, np.asarray(isa)[spos])
    np.testing.assert_array_equal(hist, np.bincount(text, minlength=sigma))


@pytest.mark.parametrize("n,nb,rate", [
    (4096, 4, 256),    # one level of 2 pair merges + root
    (6000, 6, 256),    # 3 pairs, ragged tail block
    (9000, 9, 128),    # odd region carried through a batched level
    (4096, 8, 64),     # two batched levels before the root
])
def test_batched_matches_doubling_random(n, nb, rate, tmp_path):
    rng = np.random.default_rng(n * 31 + nb)
    text = rng.integers(0, 4, n).astype(np.uint8)
    msgs = []
    out = blockwise_bwt_scaled(text, 4, _opts(n, nb, tmp_path),
                               _log_probe(msgs), sample_rate=rate,
                               lane_bucket=256, device="cpu")
    assert any("batched level" in m for m in msgs), msgs
    _check_against_doubling(text, 4, out)


def test_batched_matches_per_pair(tmp_path):
    rng = np.random.default_rng(99)
    n = 5000
    text = rng.integers(0, 4, n).astype(np.uint8)
    msgs_b, msgs_p = [], []
    out_b = blockwise_bwt_scaled(
        text, 4, _opts(n, 5, tmp_path), _log_probe(msgs_b),
        sample_rate=128, lane_bucket=128, device="cpu")
    out_p = blockwise_bwt_scaled(
        text, 4, _opts(n, 5, tmp_path, batch_merges=False),
        _log_probe(msgs_p), sample_rate=128, lane_bucket=128, device="cpu")
    assert any("batched level" in m for m in msgs_b)
    assert not any("batched level" in m for m in msgs_p)
    for a, b in zip(out_b, out_p):
        np.testing.assert_array_equal(a, b)


def test_batched_bytestream_sigma256(tmp_path):
    rng = np.random.default_rng(7)
    n = 4096
    text = rng.integers(0, 256, n).astype(np.uint8)
    msgs = []
    out = blockwise_bwt_scaled(text, 256, _opts(n, 4, tmp_path),
                               _log_probe(msgs), sample_rate=512,
                               lane_bucket=128, device="cpu")
    assert any("batched level" in m for m in msgs), msgs
    _check_against_doubling(text, 256, out)


def test_batched_cells_pass_u16(tmp_path, monkeypatch):
    # blocks a^66048 | random | c^66048 | random: in both first-level
    # merges nearly every left suffix (a run of a's longer than any in
    # the right block) lands in one cell of the level's histogram, more
    # than the 65,535 the reference's uint16 cells hold (it reran such a
    # pair with int32 cells); the port's cells are int32 from the start
    from bwtb3m_tpu_torch.engine import merge_scaled
    rng = np.random.default_rng(12)
    blk = 258 * 256         # blocks are cut at multiples of 256
    text = np.zeros(4 * blk, np.uint8)
    text[blk:2 * blk] = rng.integers(0, 4, blk)
    text[2 * blk:3 * blk] = 2
    text[3 * blk:] = rng.integers(0, 4, blk)
    text[-1] = 1            # no run of a's wraps around the end
    peaks = []
    compute = merge_scaled.BatchedGapRunner.compute

    def spy(self, *a, **k):
        compute(self, *a, **k)
        peaks.append([int(self.view(j).gap.max())
                      for j in range(len(self.specs))])

    monkeypatch.setattr(merge_scaled.BatchedGapRunner, "compute", spy)
    out = blockwise_bwt_scaled(text, 4, _opts(4 * blk, 4, tmp_path),
                               VerboseLog(0), sample_rate=8192,
                               lane_bucket=512, device="cpu")
    # the level of two merges, then the root as a batch of one
    assert [len(p) for p in peaks] == [2, 1] and min(peaks[0]) > 65535, peaks
    _check_against_doubling(text, 4, out)


def test_batched_budget_gate_falls_back(tmp_path):
    # 64 blocks of 256 symbols: a budget that holds every block sort
    # (1,280 window symbols) but no level's joint state routes every
    # level pair by pair; the outputs are the same
    rng = np.random.default_rng(3)
    n = 16384
    text = rng.integers(0, 4, n).astype(np.uint8)
    msgs = []
    out = blockwise_bwt_scaled(text, 4, _opts(n, 64, tmp_path),
                               _log_probe(msgs), sample_rate=256,
                               lane_bucket=64, device="cpu", budget=140_000)
    assert not any("batched level" in m for m in msgs), msgs
    assert sum(m.startswith("merged [") for m in msgs) == 63
    _check_against_doubling(text, 4, out)


def test_block_sort_refuses_a_block_past_the_budget(tmp_path):
    text = np.random.default_rng(4).integers(0, 4, 4096).astype(np.uint8)
    with pytest.raises(MemoryError, match="lower mem="):
        blockwise_bwt_scaled(text, 4, _opts(4096, 4, tmp_path),
                             VerboseLog(0), sample_rate=256, lane_bucket=64,
                             device="cpu", budget=1000)


def test_batched_periodic_ties(tmp_path):
    seg = np.array([0, 1, 2, 3, 1, 0, 2, 2], np.uint8)
    n = 8192
    text = np.tile(seg, n // 8)
    text[4097] = 3
    text[70] = 1
    msgs = []
    out = blockwise_bwt_scaled(text, 4, _opts(n, 4, tmp_path),
                               _log_probe(msgs), sample_rate=1024,
                               lane_bucket=64, device="cpu")
    assert any("batched level" in m for m in msgs), msgs
    _check_against_doubling(text, 4, out)


# ------------------------------------------------- runner against runner

def _level(kind):
    """(text, sigma, merges [(s, m, e)]) of one level."""
    rng = np.random.default_rng(11)
    if kind == "random4":
        return (rng.integers(0, 4, 6000).astype(np.uint8), 4,
                [(0, 1500, 3000), (3000, 4500, 6000)])
    if kind == "ragged4":      # right regions off the row grid, 3 merges
        return (rng.integers(0, 4, 7003).astype(np.uint8), 4,
                [(0, 1000, 2063), (2063, 3100, 4127), (4127, 5500, 7003)])
    if kind == "random200":
        return (rng.integers(0, 200, 5000).astype(np.uint8), 200,
                [(0, 1280, 2560), (2560, 3840, 5000)])
    if kind == "short_left":   # a left block under 64: one lane, no anchor
        return (rng.integers(0, 4, 3000).astype(np.uint8), 4,
                [(0, 40, 1500), (1500, 2200, 3000)])
    if kind == "repetitive":
        seg = rng.integers(0, 4, 97)
        t = np.tile(seg, 70)[:6000].astype(np.uint8)
        t[rng.integers(0, 6000, 30)] = rng.integers(0, 4, 30)
        return t, 4, [(512, 1800, 3000), (3000, 4400, 6000)]
    raise KeyError(kind)


def _runners(kind, layout, lanes=64, rate=128):
    text, sigma, spans = _level(kind)
    n = len(text)
    sa = np.asarray(jax_suffix_array(text.astype(np.int32), sigma)[0])
    merges_j, merges_p, packed = [], [], []
    for s, m, e in spans:
        right = sa[(sa >= m) & (sa < e)]         # rotation order of [m, e)
        rbwt = text[(right - 1) % n]
        r_start = int(np.flatnonzero(right == m)[0])
        hist = np.bincount(text[m:e], minlength=sigma)
        merges_j.append((s, m, e, rbwt, r_start, hist))
        merges_p.append((s, m, e, r_start, hist))
        packed.append(rows_from_host_bwt(rbwt, sigma, "cpu"))
    jr = JaxBatchedRunner(build_text_rows(text, sigma), text, sigma,
                          merges_j, lane_bucket=lanes, sample_rate=rate)
    jr.compute([m[4] for m in merges_j])
    pr = BatchedGapRunner(torch.from_numpy(text), text, sigma, merges_p,
                          packed, bits_for(sigma), lane_bucket=lanes,
                          sample_rate=rate, layout=layout)
    pr.compute()
    return jr, pr, text


def _expand(view, size):
    g8, ov_idx, ov_val = view.fetch_gap_compressed()
    gap = np.asarray(g8, np.int64).copy()
    gap[np.asarray(ov_idx, np.int64)] = np.asarray(ov_val, np.int64)
    return gap[:size]


@pytest.mark.parametrize("kind,layout", [
    ("random4", "auto"), ("random4", "bitplane"), ("ragged4", "auto"),
    ("ragged4", "bitplane"), ("random200", "auto"), ("short_left", "auto"),
    ("repetitive", "auto"), ("repetitive", "bitplane")])
def test_runner_matches_reference_per_merge(kind, layout):
    jr, pr, _text = _runners(kind, layout)
    assert len(jr.specs) == len(pr.specs)
    for k, (js, ps) in enumerate(zip(jr.specs, pr.specs)):
        jv, pv = jr.view(k), pr.view(k)
        assert ps.T == js.T
        np.testing.assert_array_equal(pv.final_rs, jv.final_rs)
        np.testing.assert_array_equal(
            pv.gap.numpy().astype(np.int64), _expand(jv, ps.gap_size + 1))
        assert pv.gap_checksum() == ps.m - ps.s
        jpos, jval = jv.harvest_samples()
        ppos, pval = pv.harvest_samples()
        np.testing.assert_array_equal(ppos, jpos)
        np.testing.assert_array_equal(pval, jval)
    # nothing lands in the gutters between the regions
    assert int(pr.gap.sum()) == sum(sp.m - sp.s for sp in pr.specs)


@pytest.mark.parametrize("kind", ["random4", "ragged4", "random200"])
def test_reference_level_inputs_give_the_same_chain(kind):
    """The reference runner's own constants, gt bits, lanes and rank rows
    (bit-plane / byte rows share its 256-rank row grid, so its global
    ranks carry over) through the port's plain multi-merge walk."""
    rate = 128
    jr, pr, text = _runners(kind, "bitplane" if kind != "random200"
                            else "bytes", rate=rate)
    inp = batched_inputs_from_jax(jr, rate)
    focc = focc_from_jax(jr.focc, layout=pr.focc.LAYOUT)
    np.testing.assert_array_equal(
        focc.rows.numpy()[:pr.focc.rows.shape[0] - 1],
        pr.focc.rows.numpy()[:-1])
    np.testing.assert_array_equal(inp["c_first"], pr.c_first.numpy())
    np.testing.assert_array_equal(inp["table"][:, :5], pr.table.numpy()[:, :5])
    t = {k: torch.from_numpy(inp[k]) for k in
         ("c_first", "table", "gt", "kid", "starts", "seeds", "lens")}
    gap = torch.zeros(focc.n + 1, dtype=torch.int32)
    samp = torch.full((inp["nsamp"],), -1, dtype=torch.int32)
    final = gap_chain_mk_plain(focc, torch.from_numpy(text), t["gt"],
                               t["c_first"], t["table"], t["kid"],
                               t["starts"], t["seeds"], t["lens"], gap, samp,
                               rate)
    np.testing.assert_array_equal(gap.numpy(), pr.gap.numpy())
    np.testing.assert_array_equal(samp.numpy(), pr._samp.numpy())
    lane0 = 0
    for k, sp in enumerate(jr.specs):
        np.testing.assert_array_equal(
            final.numpy()[lane0:lane0 + sp.T] - sp.rbase, sp.final_rs)
        lane0 += sp.T


@pytest.mark.parametrize("layout,sigma", [("sector", 4), ("bitplane", 4),
                                          ("bitplane", 7), ("bytes", 4),
                                          ("bytes", 200)])
def test_concat_rows_equal_each_regions_rows(layout, sigma):
    rng = np.random.default_rng(sigma)
    lens = [1000, 64, 1, 2047, 256, 511]
    bits = bits_for(sigma)
    bwts = [rng.integers(0, sigma, ln).astype(np.uint8) for ln in lens]
    packed = [rows_from_host_bwt(b, sigma, "cpu") for b in bwts]
    focc, rbase = build_focc_concat(packed, lens, sigma, bits, layout)
    block = 1 << focc.SHIFT
    assert focc.LAYOUT == layout and rbase[0] == 0
    row = 0
    for k, ln in enumerate(lens):
        own = build_focc_from_packed(packed[k], ln, sigma, bits, layout)
        assert rbase[k] == row * block
        nrows = own.rows.shape[0]
        np.testing.assert_array_equal(focc.rows[row:row + nrows].numpy(),
                                      own.rows.numpy())
        row += nrows
    assert focc.n == row * block and focc.rows.shape[0] == row + 1


def _one_merge(layout, rate=64):
    """A level of one merge over a random text, and R(p) = the number of
    rotations of [m, e) below rotation p, from the sort."""
    rng = np.random.default_rng(5)
    n, s, m, e, sigma = 5000, 700, 2600, 4900, 4
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, isa, _bwt = jax_suffix_array(text.astype(np.int32), sigma)
    sa, isa = np.asarray(sa), np.asarray(isa)
    right = sa[(sa >= m) & (sa < e)]
    R = np.searchsorted(np.sort(isa[m:e]), isa)
    run = BatchedGapRunner(
        torch.from_numpy(text), text, sigma,
        [(s, m, e, int(np.flatnonzero(right == m)[0]),
          np.bincount(text[m:e], minlength=sigma))],
        [rows_from_host_bwt(text[(right - 1) % n], sigma, "cpu")], 4,
        lane_bucket=16, sample_rate=rate, layout=layout)
    return run, text, (s, m, e), R


@pytest.mark.parametrize("layout", ["sector", "bitplane", "bytes"])
def test_level_of_one_merge_gives_the_sorts_ranks(layout):
    """The single pair merge is a batch of one: its rank base is 0, its
    lanes are the whole lane budget, and histogram, samples and final
    ranks are R itself."""
    rate = 64
    run, _text, (s, m, e), R = _one_merge(layout, rate)
    run.compute()
    sp, view = run.specs[0], run.view(0)
    assert sp.rbase == 0 and sp.T == 16 and run.focc.LAYOUT == layout
    np.testing.assert_array_equal(sp.seeds, R[sp.starts + 1])
    np.testing.assert_array_equal(view.final_rs, R[sp.starts - sp.lens + 1])
    np.testing.assert_array_equal(
        view.gap.numpy(), np.bincount(R[s:m], minlength=e - m + 1))
    pos, val = view.harvest_samples()
    np.testing.assert_array_equal(pos, np.arange(s + (-s) % rate, m, rate))
    np.testing.assert_array_equal(val, R[pos])


def test_level_with_rank_base_above_2_31():
    """Global ranks wrap nowhere below 2^32: a merge whose rank base is
    2^31 + 2^20 (its rows sit at that offset of a sparse row tensor)
    walks to the same local ranks as at base 0."""
    rng = np.random.default_rng(8)
    run, text, (s, m, e), _R = _one_merge("bytes")
    own = run.focc
    T = 8
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = rng.integers(0, e - m + 1, T)
    run._ensure_gt([int(starts.max()) + 1])
    kid, st, sd, ln = run._lanes(np.zeros(T), starts, seeds, lens)
    text_t = torch.from_numpy(text)
    want = gap_chain_mk_plain(own, text_t, run.gt_dev, run.c_first,
                              run.table, kid, st, sd, ln).numpy()

    rbase = (1 << 31) + (1 << 20)

    class _Rows:
        """Answers rows [rbase / 256, ...) from ``own``'s rows."""

        def __getitem__(self, i):
            return own.rows[i - (rbase >> 8)]

    sparse = types.SimpleNamespace(rows=_Rows(), sigma=own.sigma)
    table = from_u32_bits(run.table).numpy().copy()
    assert table.shape == (1, MERGE_WORDS)
    table[0, 1] += rbase                          # k0 = rbase + isa_m
    c_first = torch.from_numpy(u32_bits(
        rbase + from_u32_bits(run.c_first).numpy()))
    got = gap_chain_mk_plain(
        sparse, text_t, run.gt_dev, c_first,
        torch.from_numpy(u32_bits(table)), kid, st,
        torch.from_numpy(u32_bits(rbase + seeds)), ln)
    assert int(got.min()) > 1 << 31
    np.testing.assert_array_equal(got.numpy() - rbase, want)
    np.testing.assert_array_equal(
        from_u32_bits(torch.from_numpy(u32_bits(got.numpy()))).numpy(),
        got.numpy())
