"""The wide merge path of the port against the reference's
(``bwtb3m_tpu/ops/gapwide.py``, the wide branch of
``bwtb3m_tpu/engine/merge_scaled.py::_merge_pair_scaled``).

A merge of 2^32 ranks cannot run here, so, as tests/test_gapwide.py and
tests/test_devzip.py do, the wide path is pinned by forcing it
(``BWTB3M_FORCE_WIDE``) on small merges, which must be bit-identical to
the reference's forced-wide merges and to the port's narrow ones, and by
doctored inputs whose ranks straddle 2^32: rank rows whose occ counts
cross 2^32 inside the right region, a merge whose rank base lies above
2^32, a histogram whose sums pass 2^32, region files whose values pass
it.  On the CPU the chains run the plain version of the kernel's 64-bit
form.  Exact equality throughout.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import checkpoint as jck
from bwtb3m_tpu.engine import merge_scaled as jms
from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.util.log import VerboseLog
from bwtb3m_tpu_torch.engine import checkpoint as pck
from bwtb3m_tpu_torch.engine import merge_scaled as ms
from bwtb3m_tpu_torch.engine.options import BwtOptions
from bwtb3m_tpu_torch.ops import gapbatch as gb
from bwtb3m_tpu_torch.ops import wideocc as pw
from bwtb3m_tpu_torch.ops.devzip import (cnt_le_at_ranks, device_interleave,
                                         gap_cum, rows_from_host_bwt,
                                         zip_plan)
from bwtb3m_tpu_torch.util.phases import Phases

TWO32 = 1 << 32


def _texts(kind):
    rng = np.random.default_rng(31)
    if kind == "random5":
        return rng.integers(0, 5, 6144).astype(np.uint8), 5, 3072, 128
    if kind == "random200":
        return rng.integers(0, 200, 4000).astype(np.uint8), 200, 2048, 64
    base = rng.integers(0, 4, 64).astype(np.uint8)      # periodic
    return np.tile(base, 64), 4, 2048, 32


def _spy_wide(monkeypatch):
    seen = []
    init = gb.BatchedGapRunner.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("wide", False))
        init(self, *a, **kw)

    monkeypatch.setattr(gb.BatchedGapRunner, "__init__", spy)
    return seen


@pytest.mark.parametrize("kind", ["random5", "random200", "periodic"])
def test_wide_pair_merge_matches_reference_and_narrow(kind, monkeypatch):
    """tests/test_gapwide.py::test_wide_pair_merge_matches_narrow for the
    port: one forced-wide merge of the reference's block regions equals
    the reference's forced-wide merge and the port's narrow merge."""
    text, sigma, block, rate = _texts(kind)
    jctx = jms._Ctx(text, sigma, rate, JaxOptions(
        input_path="x", max_block_symbols=block), VerboseLog(0), 64)
    pctx = ms._Ctx(text, sigma, rate, BwtOptions(
        input_path="x", max_block_symbols=block, device="cpu"), None, 64,
        torch.device("cpu"), Phases("cpu"))
    (s, m), (_m, e) = ms._plan_blocks_fixed(len(text), block)[:2]
    jl = jms._sort_block_scaled(jctx, s, m)
    jr = jms._sort_block_scaled(jctx, m, e)

    def regions():
        return (ms.region_from_jax(jl, sigma), ms.region_from_jax(jr, sigma))

    narrow, = ms._merge_pairs(pctx, [regions()])
    seen = _spy_wide(monkeypatch)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    wide, = ms._merge_pairs(pctx, [regions()])
    assert seen == [True]
    want = ms.region_from_jax(jms._merge_pair_scaled(jctx, jl, jr), sigma)
    for got in (wide, want):
        assert (got.s, got.e, got.r_start) == (narrow.s, narrow.e,
                                               narrow.r_start)
        np.testing.assert_array_equal(ms._region_bwt(pctx, got),
                                      ms._region_bwt(pctx, narrow))
        for name in ("samp_pos", "samp_rank", "hist"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(narrow, name))


def test_forced_wide_build_end_to_end(monkeypatch):
    """tests/test_devzip.py::test_wide_device_interleave_matches_host_route
    and tests/test_gapwide.py::test_force_wide_build_end_to_end for the
    port: a forced-wide multi-block build (every merge wide, pair by pair
    even with batching on) equals the reference's forced-wide build, the
    port's narrow build and the doubling sort."""
    rng = np.random.default_rng(77)
    text = rng.integers(0, 4, 6000).astype(np.uint8)
    popts = BwtOptions(input_path="x", device="cpu", max_block_symbols=2048,
                       batch_merges=True, verbose=0)
    narrow = ms.blockwise_bwt_scaled(text, 4, popts, VerboseLog(0),
                                     sample_rate=512, lane_bucket=32,
                                     device="cpu")
    seen = _spy_wide(monkeypatch)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    wide = ms.blockwise_bwt_scaled(text, 4, popts, VerboseLog(0),
                                   sample_rate=512, lane_bucket=32,
                                   device="cpu")
    assert seen == [True, True]
    jopts = JaxOptions(input_path="x", output_filename="/tmp/wdt.bwt",
                       max_block_symbols=2048, batch_merges=False)
    ref = jms.blockwise_bwt_scaled(text.astype(np.int32), 4, jopts,
                                   VerboseLog(0), sample_rate=512,
                                   lane_bucket=32)
    for a, b, c in zip(wide, narrow, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    _sa, _isa, bwt = jax_suffix_array(text.astype(np.int32), 4)
    np.testing.assert_array_equal(wide[0], np.asarray(bwt).astype(np.uint8))


def test_forced_wide_compute_bwt_files(tmp_path, monkeypatch):
    """``bwtb3m engine=merge`` under BWTB3M_FORCE_WIDE writes the .bwt,
    .hist and .preisa bytes of the narrow build, and its in-process
    checkbwt and SA/ISA walk (wide rows from the hand-off) agree."""
    from bwtb3m_tpu_torch.engine import compute_bwt
    from bwtb3m_tpu_torch.engine.verify import check_bwt
    rng = np.random.default_rng(5)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 9000)]
    inp = str(tmp_path / "t.bin")
    text.tofile(inp)
    files = {}
    for mode in ("narrow", "wide"):
        if mode == "wide":
            monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
        out = str(tmp_path / (mode + ".bwt"))
        res = compute_bwt(BwtOptions(
            input_path=inp, output_filename=out, engine="merge", mem=32768,
            device="cpu", verbose=0, sa_sampling_rate=32,
            isa_sampling_rate=64))
        assert check_bwt(res, text, device="cpu")
        files[mode] = [open(out[:-4] + e, "rb").read()
                       for e in (".bwt", ".hist", ".preisa", ".sa", ".isa")]
    assert files["wide"] == files["narrow"]


def _wide_runner(layout, rate=64):
    """A wide runner of one merge over a random text, and R(p)."""
    rng = np.random.default_rng(5)
    n, s, m, e, sigma = 5000, 700, 2600, 4900, 4
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, isa, _bwt = jax_suffix_array(text.astype(np.int32), sigma)
    sa, isa = np.asarray(sa), np.asarray(isa)
    right = sa[(sa >= m) & (sa < e)]
    R = np.searchsorted(np.sort(isa[m:e]), isa)
    run = gb.BatchedGapRunner(
        torch.from_numpy(text), text, sigma,
        [(s, m, e, int(np.flatnonzero(right == m)[0]),
          np.bincount(text[m:e], minlength=sigma))],
        [rows_from_host_bwt(text[(right - 1) % n], sigma, "cpu")], 4,
        lane_bucket=16, sample_rate=rate, layout=layout, wide=True)
    return run, text, (s, m, e), R, text[(right - 1) % n]


@pytest.mark.parametrize("layout", ["sector", "bitplane", "bytes"])
def test_wide_runner_on_counts_across_2_32(layout):
    """The wide runner's anchors and chains give R itself, and they still
    do on rank rows doctored so that every symbol's occ count crosses
    2^32 inside the right region (c_first lowered by the same base):
    every rank query reads a hi word, the int64 arithmetic carries."""
    run, _text, (s, m, e), R, rbwt = _wide_runner(layout)
    run.compute()
    assert isinstance(run.focc, pw.WideOcc) and run.gap.dtype == torch.int64
    view = run.view(0)
    np.testing.assert_array_equal(view.gap.numpy(),
                                  np.bincount(R[s:m], minlength=e - m + 1))
    pos, val = view.harvest_samples()
    np.testing.assert_array_equal(val, R[pos])
    cnt = np.bincount(rbwt, minlength=4)
    B = torch.from_numpy((TWO32 - cnt // 2).astype(np.int64))
    doc = pw.doctored(torch.from_numpy(rbwt), 4, layout, B)
    assert int((doc.thr != pw.THR_PAD).sum()) == 4
    gap0, samp0 = run.gap.clone(), run._samp.clone()
    run.focc = doc
    run.c_first = run.c_first - B
    run.compute()
    assert torch.equal(run.gap, gap0) and torch.equal(run._samp, samp0)


def test_wide_chain_with_rank_base_above_2_32():
    """A merge whose rank base is 2^32 + 2^20 (its rows at that offset of
    a sparse row tensor) walks to the same local ranks as at base 0: the
    wide chain's int64 ranks, constants and seeds wrap nowhere."""
    import types
    rng = np.random.default_rng(8)
    run, text, (s, m, e), _R, _rbwt = _wide_runner("bytes")
    own = run.focc
    T = 8
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = rng.integers(0, e - m + 1, T)
    run._ensure_gt([int(starts.max()) + 1])
    kid, st, sd, ln = run._lanes(np.zeros(T), starts, seeds, lens)
    text_t = torch.from_numpy(text)
    want = gb.gap_chain_mk_plain(own, text_t, run.gt_dev, run.c_first,
                                 run.table, kid, st, sd, ln).numpy()
    rbase = TWO32 + (1 << 20)

    class _Rows:
        def __getitem__(self, i):
            return own.rows[i - (rbase >> 8)]

    sparse = pw.WideOcc(types.SimpleNamespace(
        rows=_Rows(), sigma=own.sigma, SHIFT=own.SHIFT, LAYOUT="bytes"),
        own.thr, own.C, own.n)
    table = run.table.clone()
    table[0, gb.M_K0] += rbase
    got = gb.gap_chain_mk_plain(sparse, text_t, run.gt_dev,
                                run.c_first + rbase, table, kid, st,
                                torch.from_numpy(rbase + seeds), ln)
    assert int(got.min()) > TWO32
    np.testing.assert_array_equal(got.numpy() - rbase, want)


def test_zip_helpers_exact_past_2_32():
    """tests/test_devzip.py::test_wide_pair_helpers_exact_past_2_32 for
    the port: the zip's helpers are int64 (no (hi, lo) twins), exact when
    the cumulative sums pass 2^32, as the reference's wide helpers."""
    from bwtb3m_tpu.ops.devzip import cnt_le_at_ranks_w, gap_row_cum_excl_w
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(9)
    rows = 8
    cells = rng.integers(0, 1 << 30, (rows, 256)).astype(np.int64)
    flat = cells.reshape(-1)
    want = np.cumsum(flat)                         # ~2^41 total
    for dt in (torch.int32, torch.int64):
        gap = torch.from_numpy(flat).to(dt)
        np.testing.assert_array_equal(gap_cum(gap).numpy(), want)
    gap = torch.from_numpy(flat)
    ranks = rng.integers(0, rows * 256, 50)
    got = cnt_le_at_ranks(gap, ranks)
    np.testing.assert_array_equal(got, want[ranks])
    gj = jnp.asarray(cells.astype(np.int32))
    np.testing.assert_array_equal(
        got, cnt_le_at_ranks_w(gj, gap_row_cum_excl_w(gj), ranks))
    B = rows * 256 - 1
    F = np.arange(B) + want[:B]
    ts = np.sort(rng.integers(0, int(F[-1]) + 10, 40))
    total, r_starts, at = zip_plan(gap, B, ts, ranks)
    assert total == int(flat.sum()) > TWO32
    np.testing.assert_array_equal(r_starts, np.searchsorted(F, ts))
    np.testing.assert_array_equal(at, want[ranks])


def test_zip_of_a_wide_merge_in_place_cumsum():
    """A wide merge's int64 histogram is cumsummed in place; the zip
    from that cumsum equals the zip from the histogram."""
    rng = np.random.default_rng(2)
    A, B = 3000, 1000
    gap = torch.from_numpy(np.bincount(rng.integers(0, B + 1, A),
                                       minlength=B + 1).astype(np.int64))
    left = torch.from_numpy(rng.integers(0, 16, A).astype(np.uint8))
    right = torch.from_numpy(rng.integers(0, 16, B).astype(np.uint8))
    from bwtb3m_tpu_torch.ops.devzip import pack_region
    lp, rp = pack_region(left, 4), pack_region(right, 4)
    want = device_interleave(lp, A, rp, B, gap, 4, chunk=700)
    cum = gap.clone().cumsum_(0)
    assert torch.equal(device_interleave(lp, A, rp, B, gap, 4, cum, 700),
                       want)


def test_scale_gate_at_2_35(tmp_path):
    """tests/test_gapwide.py::test_scale_gate_moved_to_2_35 for the port:
    lengths below 2^35 pass, 2^35 raises, before anything is uploaded (a
    sparse 32 GiB memory map stands for the text)."""
    ms._validate_scale((1 << 33) + 5)
    ms._validate_scale((1 << 35) - 1)
    with pytest.raises(ValueError, match="2\\^35"):
        ms._validate_scale(1 << 35)
    path = tmp_path / "huge.u8"
    with open(path, "wb") as f:
        f.truncate(1 << 35)
    text = np.memmap(path, np.uint8, "r")
    with pytest.raises(ValueError, match="2\\^35"):
        ms.blockwise_bwt_scaled(text, 4, BwtOptions(input_path="x",
                                                    device="cpu"),
                                VerboseLog(0), device="cpu")


def test_wide_merges_decided_per_pair(monkeypatch):
    """Which merges take the wide path: the reference's bounds (right
    region, left block), positions past 2^32 (the narrow kernel's uint32
    positions), BWTB3M_FORCE_WIDE; a level with a wide pair is never
    batched, and its memory figure counts int64 cells cumsummed in
    place."""
    def reg(s, e):
        return ms.Region(s, e, None, None, None, None, 0, None)

    small = (reg(0, 1 << 27), reg(1 << 27, 1 << 28))
    assert not ms._is_wide(*small)
    assert ms._is_wide(reg(0, 1 << 32), reg(1 << 32, (1 << 32) + 256))
    assert ms._is_wide(reg(0, 1 << 27), reg(1 << 27, (1 << 27) + TWO32))
    assert ms._is_wide(reg(1 << 32, (1 << 32) + 5),
                       reg((1 << 32) + 5, (1 << 32) + 9))
    assert not ms._is_wide(reg((1 << 32) - 9, (1 << 32) - 5),
                           reg((1 << 32) - 5, 1 << 32))
    # the lanes walk the left block only: a right region past 2^32 alone
    # keeps the narrow kernel
    assert not ms._is_wide(reg((1 << 32) - 9, (1 << 32) - 5),
                           reg((1 << 32) - 5, (1 << 32) + 100))
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    assert ms._is_wide(*small)
    assert not ms._level_fits_batched(None, [small, small])
    est_w = ms.level_bytes_estimate([small], 4, 4, wide=True)
    est_n = ms.level_bytes_estimate([small], 4, 4)
    assert est_n - est_w >= 4 * (1 << 27)


@pytest.mark.parametrize("bits", [4, 8])
def test_region_file_past_2_32_round_trips(tmp_path, bits):
    """Region files whose r_start, samples and histogram pass 2^32 load
    the same in both packages, either way."""
    rng = np.random.default_rng(bits)
    n = 1001
    bwt = rng.integers(0, 16 if bits == 4 else 256, n).astype(np.uint8)
    s = (1 << 33) + 12345
    spos = s + np.arange(0, n, 64, dtype=np.int64)
    srank = rng.integers(TWO32, 1 << 34, len(spos)).astype(np.int64)
    r0 = (1 << 33) + 7
    hist = rng.integers(TWO32, 1 << 33, 16 if bits == 4 else 256)
    for save, load in ((pck.save_region_file, jck.load_region_file),
                       (lambda p, k, s_, e, b, bw, *rest:
                        jck.save_region_file(p, k, s_, e, b, bw, *rest),
                        pck.load_region_file)):
        path = str(tmp_path / "r.npz")
        packed = pck.pack_host(bwt, bits)
        save(path, "k", s, s + n, bits,
             packed if save is pck.save_region_file else bwt, spos, srank,
             r0, hist)
        got = load(path, "k")
        assert (got[0], got[1], got[5]) == (s, s + n, r0)
        for a, b in zip((got[2], got[3], got[4], got[6]),
                        (bwt, spos, srank, hist)):
            np.testing.assert_array_equal(a, b)
