"""The LF-walk and gap-chain CUDA kernels, through each of their entry
points (``bwt_lf_walk``: final rank, verify, harvest; ``bwt_lf_select``:
the select walk with its summary bitmap and lanes that refill;
``bwt_gap_chain_mk``: recording and anchor forms, one merge and several)
and on each rank-row layout (sector, bit-plane, bytes), and the Kasai
walk ``bwt_kasai_plcp`` (nibble and byte windows, slabs, step caps,
ragged lanes, p0 inside a lane and at its edge), against the plain
PyTorch versions, on the card; and the multi-rank path on the one card:
NCCL in a group of one, and two ranks sharing the card over gloo
(``parallel/``).  Skipped without a CUDA device; on
one, run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(the suite's conftest imports JAX, which the card's machine need not
have).  Every comparison is exact: the walks are integer."""

import numpy as np
import pytest
import torch

from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops.doubling import suffix_array
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


ROWS = [(4, "sector"), (3, "sector"), (4, "bitplane"), (7, "bitplane"),
        (200, "bytes")]


def _build(sigma, n, rate, cuda, layout="auto"):
    rng = np.random.default_rng(sigma + n)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, isa, bwt = suffix_array(text, sigma, cuda)
    focc = build_focc_host(bwt.astype(np.uint8), sigma, cuda, layout)
    assert layout in ("auto", focc.LAYOUT)
    pos = np.arange(0, n, rate, dtype=np.int64)
    seg = np.diff(np.r_[pos, n])
    start = (pos + seg) % n               # lane 0 wraps through n-1, ...
    lanes = [torch.from_numpy(a).to(cuda) for a in (isa[start], start, seg)]
    return text, sa, isa, focc, lanes


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_lf_walk_kernel_matches_plain(cuda, sigma, layout):
    _t, _sa, _isa, focc, (r0, _p0, _seg) = _build(
        sigma, (1 << 16) + 37, 16, cuda, layout)
    before = lw.lf_walk.launches
    got = lw.lf_walk(focc, r0, 300)
    assert lw.lf_walk.launches == before + 1
    assert torch.equal(got, lw.lf_walk_plain(focc, r0, 300))


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_verify_kernel_matches_plain(cuda, sigma, layout):
    text, _sa, _isa, focc, (r0, p0, seg) = _build(
        sigma, (1 << 16) + 37, 64, cuda, layout)
    t = torch.from_numpy(text).to(cuda)
    before = lw.lf_walk.launches
    bad = lw.verify_walk(focc, t, r0, p0, seg)
    assert lw.lf_walk.launches == before + 1
    assert int(bad.sum()) == 0
    t[1000] = (t[1000] + 1) % sigma
    bad = lw.verify_walk(focc, t, r0, p0, seg)
    assert torch.equal(bad, lw.verify_walk_plain(focc, t, r0, p0, seg))
    assert int(bad.sum()) == 1


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_harvest_kernel_matches_plain(cuda, sigma, layout):
    n = (1 << 16) + 37
    _t, sa, isa, focc, (r0, p0, seg) = _build(sigma, n, 64, cuda, layout)
    before = lw.lf_walk.launches
    got = lw.harvest_walk(focc, r0, p0, seg, 32, 48)
    assert lw.lf_walk.launches == before + 1
    want = lw.harvest_walk_plain(focc, r0, p0, seg, 32, 48)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].cpu().numpy(), sa[::32])
    np.testing.assert_array_equal(got[1].cpu().numpy(), isa[::48])


def test_kernels_refuse_out_of_range_lanes(cuda):
    _t, _sa, _isa, focc, (r0, p0, seg) = _build(4, 5000, 64, cuda)
    bad = r0.clone()
    bad[3] = focc.n
    with pytest.raises(ValueError, match="ranks outside"):
        lw.lf_walk(focc, bad, 1)
    with pytest.raises(ValueError, match="positions outside"):
        lw.harvest_walk(focc, r0, p0 - 100, seg, 32, 48)


def _gap_case(sigma, n, cuda, layout, lanes=512):
    """A merge of [0, m) into [m, n) as a level of one: the right
    region's rank rows from the sorted rotations of [m, n), lanes over
    the left block seeded from the sort (so every chain is exact), the
    runner's own inputs."""
    from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
    from bwtb3m_tpu_torch.ops.gapbatch import BatchedGapRunner
    rng = np.random.default_rng(sigma * 31 + n)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    m = n // 2
    sa, isa, _bwt = suffix_array(text, sigma, "cpu")
    right = sa[sa >= m]                          # rotation order of M
    rbwt = text[(right - 1) % n]
    rank_in_m = np.searchsorted(np.sort(isa[m:]), isa)   # R(p)
    hist = np.bincount(text[m:], minlength=sigma)
    runner = BatchedGapRunner(
        torch.from_numpy(text).to(cuda), text, sigma,
        [(0, m, n, int(rank_in_m[m]), hist)],
        [rows_from_host_bwt(rbwt, sigma, cuda)], bits_for(sigma),
        lane_bucket=lanes, sample_rate=64, layout=layout)
    bounds = np.linspace(0, m, lanes + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = rank_in_m[(starts + 1) % n]
    return runner, starts, seeds, lens, rank_in_m


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_gap_chain_kernel_matches_plain(cuda, sigma, layout):
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    runner, starts, seeds, lens, R = _gap_case(sigma, (1 << 16) + 37, cuda,
                                              layout)
    assert layout in ("auto", runner.focc.LAYOUT)
    runner._ensure_gt([int(starts.max()) + 1])
    kd, st, sd, ln = runner._lanes(np.zeros(len(starts)), starts, seeds,
                                   lens)
    args = (runner.focc, runner.text_dev, runner.gt_dev, runner.c_first,
            runner.table, kd, st, sd, ln)
    sp = runner.specs[0]
    m = sp.m
    outs = []
    for fn in (gb.chain_walk_mk, gb.gap_chain_mk_plain):
        gap = torch.zeros(runner.focc.n + 1, dtype=torch.int32, device=cuda)
        samp = torch.full((sp.nsamp,), -1, dtype=torch.int32, device=cuda)
        before = dict(gb.LAUNCHES)
        final = fn(*args, gap, samp, 64)
        if fn is gb.chain_walk_mk:
            assert gb.LAUNCHES["chain"] == before["chain"] + 1
        outs.append((final, gap, samp))
    (fk, gk, sk), (fp, gp, sp_) = outs
    assert torch.equal(fk, fp) and torch.equal(gk, gp) \
        and torch.equal(sk, sp_)
    np.testing.assert_array_equal(sk.cpu().numpy(), R[0:m:64])
    np.testing.assert_array_equal(
        gk.cpu().numpy(), np.bincount(R[:m], minlength=runner.focc.n + 1))
    # the anchor form from both bounds
    for r0 in (0, sp.gap_size):          # the top seed reads the last row
        sd0 = torch.full_like(sd, r0)
        before = gb.LAUNCHES["anchor"]
        a = gb.anchor_walk_mk(*args[:7], sd0, ln)
        assert gb.LAUNCHES["anchor"] == before + 1
        assert torch.equal(a, gb.gap_chain_mk_plain(*args[:7], sd0, ln))


def _level_case(sigma, K, cuda, layout, lanes):
    """A level of K merges over consecutive spans of one text, through
    ``BatchedGapRunner`` on the card (anchors and chains by the kernel)."""
    from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
    from bwtb3m_tpu_torch.ops.gapbatch import BatchedGapRunner
    rng = np.random.default_rng(sigma * 7 + K)
    span = 9001
    n = K * span + 123
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, isa, _bwt = suffix_array(text, sigma, "cpu")
    merges, packed, Rs = [], [], []
    for k in range(K):
        s, e = k * span, (k + 1) * span
        m = s + span // 3 + 17 * k          # left blocks of several sizes
        right = sa[(sa >= m) & (sa < e)]
        rank_in_m = np.searchsorted(np.sort(isa[m:e]), isa)
        merges.append((s, m, e, int(np.flatnonzero(right == m)[0]),
                       np.bincount(text[m:e], minlength=sigma)))
        packed.append(rows_from_host_bwt(text[(right - 1) % n], sigma, cuda))
        Rs.append(rank_in_m)
    runner = BatchedGapRunner(torch.from_numpy(text).to(cuda), text, sigma,
                              merges, packed, bits_for(sigma),
                              lane_bucket=lanes, sample_rate=64,
                              layout=layout)
    return runner, merges, Rs


@pytest.mark.parametrize("sigma,layout", ROWS)
@pytest.mark.parametrize("K,lanes", [(1, 64), (2, 256), (5, 1024), (5, 40)])
def test_gap_chain_mk_kernel_matches_plain(cuda, sigma, layout, K, lanes):
    """Both forms of ``bwt_gap_chain_mk`` against the plain version and
    against the sort: the engine's own level (anchors by the anchor form,
    chains by the recording form), then the same lanes replayed through
    the plain version."""
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    runner, merges, Rs = _level_case(sigma, K, cuda, layout, lanes)
    before = dict(gb.LAUNCHES)
    runner.compute()
    assert gb.LAUNCHES["chain"] == before["chain"] + 1
    assert gb.LAUNCHES["anchor"] >= before["anchor"] + (2 if lanes > K else 0)
    kid = np.concatenate([np.full(sp.T, sp.k) for sp in runner.specs])
    starts = np.concatenate([sp.starts for sp in runner.specs])
    lens = np.concatenate([sp.lens for sp in runner.specs])
    seeds = np.concatenate([sp.seeds for sp in runner.specs])
    kd, st, sd, ln = runner._lanes(kid, starts, seeds, lens)
    gap = torch.zeros_like(runner.gap)
    samp = torch.full_like(runner._samp, -1)
    final = gb.gap_chain_mk_plain(runner.focc, runner.text_dev, runner.gt_dev,
                                  runner.c_first, runner.table, kd, st, sd,
                                  ln, gap, samp, 64)
    assert torch.equal(gap, runner.gap) and torch.equal(samp, runner._samp)
    lane0 = 0
    for k, sp in enumerate(runner.specs):
        s, m, e = merges[k][:3]
        view = runner.view(k)
        np.testing.assert_array_equal(
            final.cpu().numpy()[lane0:lane0 + sp.T] - sp.rbase, sp.final_rs)
        lane0 += sp.T
        np.testing.assert_array_equal(
            view.gap.cpu().numpy(),
            np.bincount(Rs[k][s:m], minlength=sp.gap_size + 1))
        pos, val = view.harvest_samples()
        np.testing.assert_array_equal(val, Rs[k][pos])
    # the anchor form on the chain's lanes, from each merge's top rank
    top = np.array([runner.specs[k].rbase + runner.specs[k].gap_size
                    for k in kid])
    kd, st, sd, ln = runner._lanes(kid, starts, top, np.minimum(lens, 50))
    args = (runner.focc, runner.text_dev, runner.gt_dev, runner.c_first,
            runner.table, kd, st, sd, ln)
    assert torch.equal(gb.anchor_walk_mk(*args), gb.gap_chain_mk_plain(*args))


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_select_kernel_matches_plain(cuda, sigma, layout):
    n = (1 << 16) + 37
    _t, sa, isa, focc, _lanes = _build(sigma, n, 64, cuda, layout)
    marks = isa[::97]
    words = np.zeros(n // 32 + 1, np.uint32)
    np.bitwise_or.at(words, marks >> 5,
                     np.uint32(1) << (marks & 31).astype(np.uint32))
    bitwords = torch.from_numpy(words.view(np.int32)).to(cuda)
    rng = np.random.default_rng(sigma)
    r0 = torch.from_numpy(np.r_[rng.integers(0, n, 5000), marks[:50], 0,
                                n - 1]).to(cuda)
    before = lw.lf_walk.launches
    r_hit, steps = lw.select_walk(focc, bitwords, r0, 300)
    assert lw.lf_walk.launches == before + 1
    r_p, s_p = lw.select_walk_plain(focc, bitwords, r0, 300)
    assert torch.equal(r_hit, r_p) and torch.equal(steps, s_p)
    assert int(steps.min()) == 0 and 0 < int(steps.max()) <= 97
    # SA[wanted] = SA[hit] + steps
    np.testing.assert_array_equal(
        (sa[r_hit.cpu().numpy()] + steps.cpu().numpy()) % n,
        sa[r0.cpu().numpy()])
    # a cap below the longest walk leaves -1 in both
    r_c, s_c = lw.select_walk(focc, bitwords, r0, 10)
    r_cp, s_cp = lw.select_walk_plain(focc, bitwords, r0, 10)
    assert torch.equal(r_c, r_cp) and torch.equal(s_c, s_cp)
    assert int((s_c < 0).sum()) > 0


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_select_kernel_refills_its_lanes(cuda, sigma, layout):
    """The persistent grid against the plain version where its lanes
    refill: more wanted ranks than resident threads (a grid of 2 blocks
    and the wrapper's own), duplicates, ranks that hit at step 0, lanes
    that reach the cap (-1), and summary false hits: marks in blocks the
    walks pass without landing on them."""
    n = (1 << 17) + 37
    _t, sa, isa, focc, _lanes = _build(sigma, n, 64, cuda, layout)
    rng = np.random.default_rng(sigma + 1)
    marks = np.unique(isa[::211])
    # a decoy in the summary block of each of 2,000 random ranks: the
    # block's bit is set there although the rank is not a mark
    decoys = rng.integers(0, n, 2000)
    decoys = (decoys & ~255) | ((decoys + 1 + rng.integers(0, 200, 2000))
                                & 255)
    decoys = np.setdiff1d(np.clip(decoys, 0, n - 1), marks)
    words = np.zeros(n // 32 + 1, np.uint32)
    np.bitwise_or.at(words, marks >> 5,
                     np.uint32(1) << (marks & 31).astype(np.uint32))
    bitwords = torch.from_numpy(words.view(np.int32)).to(cuda)
    with_decoys = words.copy()
    np.bitwise_or.at(with_decoys, decoys >> 5,
                     np.uint32(1) << (decoys & 31).astype(np.uint32))
    summary = lw.select_summary(
        torch.from_numpy(with_decoys.view(np.int32)).to(cuda))
    want = np.r_[rng.integers(0, n, 150_000), marks[:300], marks[:300], 0,
                 n - 1, np.repeat(rng.integers(0, n, 50), 7)]
    r0 = torch.from_numpy(want).to(cuda)
    r32 = lw.as_u32_bits(r0)
    for cap in (400, 30, 0):
        r_p, s_p = lw.select_walk_plain(focc, bitwords, r0, cap)
        for blocks in (2, lw.select_blocks(cuda, len(want))):
            before = lw.LAUNCHES["select"]
            r_k, s_k = lw._launch_select(focc, bitwords, summary, r32, cap,
                                         blocks)
            torch.cuda.synchronize()
            assert lw.LAUNCHES["select"] == before + 1
            assert torch.equal(lw.from_u32_bits(r_k), r_p), (cap, blocks)
            assert torch.equal(s_k.long(), s_p), (cap, blocks)
        if cap == 400:
            assert int(s_p.min()) == 0 and int((s_p == 0).sum()) >= 600
            assert int(s_p.max()) > 30
            np.testing.assert_array_equal(
                (sa[r_p.cpu().numpy()] + s_p.cpu().numpy()) % n, sa[want])
        elif cap == 30:
            assert int((s_p < 0).sum()) > 0
        else:
            assert bool((s_p == -1).all()) and torch.equal(r_p, r0)
    # the wrapper builds its own summary: the same results
    r_w, s_w = lw.select_walk(focc, bitwords, r0, 400)
    r_p, s_p = lw.select_walk_plain(focc, bitwords, r0, 400)
    assert torch.equal(r_w, r_p) and torch.equal(s_w, s_p)


def test_kernels_refuse_rows_of_another_layout(cuda):
    from bwtb3m_tpu_torch.ops.focc_bp import FusedOccBP
    _t, _sa, _isa, focc, (r0, _p0, _seg) = _build(4, 5000, 64, cuda,
                                                  "sector")
    wrong = FusedOccBP(focc.rows, focc.C, focc.n, focc.sigma)
    with pytest.raises(ValueError, match="do not match"):
        lw.lf_walk(wrong, r0, 1)
    odd = type(focc)(focc.rows.reshape(-1)[16:-16].view(-1, 32), focc.C,
                     focc.n - 64, focc.sigma)
    with pytest.raises(ValueError, match="32-byte aligned"):
        lw.lf_walk(odd, r0.clamp(max=focc.n - 65), 1)


# ------------------------------------------------- the 64-bit forms (wide)

def _doctored(focc, bwt, sigma, layout, cuda):
    """Wide rows of ``bwt`` whose occ counts cross 2^32 halfway through
    every symbol (``ops/wideocc.py::doctored``): each rank reads a hi
    word, and a walk still visits the undoctored ranks."""
    from bwtb3m_tpu_torch.ops import wideocc as pw
    cnt = np.bincount(bwt, minlength=sigma)
    base = torch.from_numpy(((1 << 32) - cnt // 2).astype(np.int64))
    w = pw.doctored(torch.from_numpy(bwt.astype(np.uint8)).to(cuda), sigma,
                    layout if layout != "auto" else focc.LAYOUT, base)
    assert int((w.thr != pw.THR_PAD).sum()) == int((cnt > 0).sum())
    return w


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_lf_walk_w_kernel_matches_plain(cuda, sigma, layout):
    """``bwt_lf_walk_w`` (final rank, verify and harvest visits) on rows
    whose counts straddle 2^32, against its plain version and the sort;
    on undoctored rows the narrow and the 64-bit form give the same
    ranks."""
    from bwtb3m_tpu_torch.ops.focc_build import build_focc_device
    n = (1 << 16) + 37
    text, sa, isa, focc, (r0, p0, seg) = _build(sigma, n, 64, cuda, layout)
    bwt = text[(sa - 1) % n]
    w = _doctored(focc, bwt, sigma, layout, cuda)
    before = dict(lw.LAUNCHES)
    got = lw.lf_walk(w, r0, 300)
    assert lw.LAUNCHES["none64"] == before["none64"] + 1
    assert torch.equal(got, lw.lf_walk_plain(w, r0, 300))
    assert torch.equal(got, lw.lf_walk(focc, r0, 300))
    t = torch.from_numpy(text).to(cuda)
    t[1000] = (t[1000] + 1) % sigma
    bad = lw.verify_walk(w, t, r0, p0, seg)
    assert lw.LAUNCHES["verify64"] == before["verify64"] + 1
    assert torch.equal(bad, lw.verify_walk_plain(w, t, r0, p0, seg))
    assert int(bad.sum()) == 1
    sa_k, isa_k = lw.harvest_walk(w, r0, p0, seg, 32, 48)
    assert lw.LAUNCHES["harvest64"] == before["harvest64"] + 1
    sa_p, isa_p = lw.harvest_walk_plain(w, r0, p0, seg, 32, 48)
    assert torch.equal(sa_k, sa_p) and torch.equal(isa_k, isa_p)
    np.testing.assert_array_equal(sa_k.cpu().numpy(), sa[::32])
    np.testing.assert_array_equal(isa_k.cpu().numpy(), isa[::48])
    plain_rows = build_focc_device(torch.from_numpy(bwt.astype(np.uint8))
                                   .to(cuda), sigma, w.LAYOUT, wide=True)
    assert torch.equal(lw.lf_walk(plain_rows, r0, 300), got)


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_gap_chain_mk_w_kernel_matches_plain(cuda, sigma, layout):
    """``bwt_gap_chain_mk_w``: a wide runner's own anchors and chains on
    the card give the sort's ranks, on its rows and on rows doctored so
    that every count crosses 2^32 (c_first lowered by the same base);
    both forms against the plain version on the same lanes."""
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
    n = (1 << 16) + 37
    rng = np.random.default_rng(sigma * 31 + n)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    m = n // 2
    sa, isa, _bwt = suffix_array(text, sigma, "cpu")
    right = sa[sa >= m]
    rbwt = text[(right - 1) % n]
    R = np.searchsorted(np.sort(isa[m:]), isa)
    runner = gb.BatchedGapRunner(
        torch.from_numpy(text).to(cuda), text, sigma,
        [(0, m, n, int(R[m]), np.bincount(text[m:], minlength=sigma))],
        [rows_from_host_bwt(rbwt, sigma, cuda)], bits_for(sigma),
        lane_bucket=512, sample_rate=64, layout=layout, wide=True)
    for doctor in (False, True):
        if doctor:
            w = _doctored(runner.focc, rbwt, sigma, layout, cuda)
            cnt = np.bincount(rbwt, minlength=sigma)
            runner.focc = w
            runner.c_first = runner.c_first - torch.from_numpy(
                ((1 << 32) - cnt // 2).astype(np.int64)).to(cuda)
        before = dict(gb.LAUNCHES)
        runner.compute()
        assert gb.LAUNCHES["chain64"] == before["chain64"] + 1
        assert gb.LAUNCHES["anchor64"] >= before["anchor64"] + 2
        assert runner.gap.dtype == torch.int64
        np.testing.assert_array_equal(runner.gap.cpu().numpy(),
                                      np.bincount(R[:m], minlength=n - m + 1))
        np.testing.assert_array_equal(runner.view(0).harvest_samples()[1],
                                      R[0:m:64])
        sp = runner.specs[0]
        kd, st, sd, ln = runner._lanes(np.zeros(sp.T), sp.starts, sp.seeds,
                                       sp.lens)
        args = (runner.focc, runner.text_dev, runner.gt_dev, runner.c_first,
                runner.table, kd, st)
        gap = torch.zeros_like(runner.gap)
        samp = torch.full_like(runner._samp, -1)
        fp = gb.gap_chain_mk_plain(*args, sd, ln, gap, samp, 64)
        assert torch.equal(gap, runner.gap) and torch.equal(
            samp, runner._samp)
        np.testing.assert_array_equal(fp.cpu().numpy(), sp.final_rs)
        for r0 in (0, sp.gap_size):
            sd0 = torch.full_like(sd, r0)
            ln0 = ln.clamp(max=50)
            assert torch.equal(gb.anchor_walk_mk(*args, sd0, ln0),
                               gb.gap_chain_mk_plain(*args, sd0, ln0))


def _kasai_case(kind, n, lanes, cuda, a=0, b=None):
    """The walk's arrays for the slab [a, b) of a text, on the card, as
    ``lcp/plcp.py`` sets them up."""
    from bwtb3m_tpu_torch.lcp.plcp import _lane_bounds, _pack_text_words
    rng = np.random.default_rng(n)
    sigma = 200 if kind == "bytes" else 4
    text = rng.integers(0, sigma, n).astype(np.uint8)
    if kind == "ones":
        text[:] = 1
    elif kind == "repeats":
        text[100:100 + n // 4] = text[n // 2:n // 2 + n // 4]
    b = n if b is None else b
    sa, _isa, _bwt = suffix_array(text, sigma, cuda)
    phi = np.zeros(n, np.int64)
    phi[sa[1:]] = sa[:-1]
    words = _pack_text_words(text, sigma, cuda)
    p, pend = _lane_bounds(a, b, lanes, cuda)
    phi = torch.from_numpy(phi[a:b].astype(np.int32)).to(cuda)
    return text, sa, words, (phi, int(sa[0])), p, pend, \
        4 if sigma <= 16 else 8


@pytest.mark.parametrize("kind,n,lanes,slab", [
    ("dna", (1 << 16) + 37, 4096, None), ("bytes", (1 << 16) + 3, 4096, None),
    ("repeats", 1 << 16, 128, None), ("ones", 4099, 64, None),
    ("dna", (1 << 16) + 37, 1000, (20000, 50001)), ("dna", 301, 4096, None)])
def test_kasai_kernel_matches_plain(cuda, kind, n, lanes, slab):
    from bwtb3m_tpu_torch.lcp.plcp import kasai_plcp
    from bwtb3m_tpu_torch.ops import kasai as K
    a, b = slab or (0, n)
    text, sa, words, (phi, p0), p, pend, bits = _kasai_case(
        kind, n, lanes, cuda, a, b)
    for steps in (1, 7, 2048, None):
        outs = []
        for fn in (K.kasai_walk, K.kasai_plain):
            plcp = torch.zeros(b - a, dtype=torch.int32, device=cuda)
            taken = torch.zeros(len(p), dtype=torch.int32, device=cuda)
            before = K.kasai_walk.launches
            outs.append(fn(words, phi, p0, plcp, p, torch.zeros_like(p),
                           pend, n, a, bits, steps=steps, taken=taken)
                        + (taken,))
            if fn is K.kasai_walk:
                assert K.kasai_walk.launches == before + 1
        for x, y in zip(*outs):
            assert torch.equal(x, y), (kind, steps)
    assert int(outs[0][3].sum()) >= b - a     # a commit per position
    want = kasai_plcp(text.astype(np.int32), sa)[a:b]
    np.testing.assert_array_equal(outs[0][0].cpu().numpy(), want)


@pytest.mark.parametrize("kind,where", [
    ("dna", "inside"), ("dna", "edge"), ("bytes", "inside"),
    ("bytes", "edge"), ("repeats", "inside"), ("wrap", "edge")])
def test_kasai_kernel_ragged_lanes_match_plain(cuda, kind, where):
    """The kernel against its plain version after 1, 7 and 2,048 steps,
    resumed, and to the end, on lanes whose bounds are no multiples of 8,
    lanes of 1-7 positions, p0 inside a lane and at a lane's edge,
    10,000-symbol repeats and a window that wraps past n; over the whole
    text and over a slab whose tensors start off a 32-byte sector."""
    from bwtb3m_tpu_torch.lcp.plcp import _pack_text_words, kasai_plcp
    from bwtb3m_tpu_torch.ops import kasai as K
    n = 40_009
    rng = np.random.default_rng(n + len(kind))
    sigma = 200 if kind == "bytes" else 4
    text = rng.integers(0, sigma, n).astype(np.uint8)
    if kind == "repeats":
        for dst in (15_000, 27_000):
            text[dst:dst + 10_000] = text[500:10_500]
    elif kind == "wrap":
        text[n - 600:] = text[:600]
    sa, _isa, _bwt = suffix_array(text, sigma, cuda)
    p0 = int(sa[0])
    phi_h = np.zeros(n, np.int64)
    phi_h[sa[1:]] = sa[:-1]
    words = _pack_text_words(text, sigma, cuda)
    bits = 4 if sigma <= 16 else 8
    cuts = set(rng.choice(np.arange(1, n), 3000, replace=False).tolist())
    for c in rng.choice(np.arange(8, n - 16), 300, replace=False):
        cuts.update(int(c) + d for d in (0, 1, 3, 10))
    cuts = {c for c in cuts if 0 < c < n and c % 8}
    if where == "inside":
        cuts -= set(range(p0 - 3, p0 + 4))
    else:
        cuts.update({p0, p0 + 1} & set(range(1, n)))
    want = kasai_plcp(text.astype(np.int32), sa)
    if kind == "wrap":
        assert int((np.arange(n) + want).max()) > n
    for a, b, skew in ((0, n, 0), (3, n - 5, 3)):
        bounds = np.array(sorted({c for c in cuts if a < c < b} | {a, b}),
                          np.int64)
        p = torch.from_numpy(bounds[:-1]).to(cuda)
        pend = torch.from_numpy(bounds[1:]).to(cuda)
        # the slab's Phi and PLCP views start ``skew`` words into a sector
        phi_store = torch.zeros(b - a + 8, dtype=torch.int32, device=cuda)
        phi = phi_store[skew:skew + b - a]
        phi.copy_(torch.from_numpy(phi_h[a:b].astype(np.int32)))
        states = []
        for fn in (K.kasai_walk, K.kasai_plain):
            plcp = torch.zeros(b - a + 8, dtype=torch.int32,
                               device=cuda)[skew:skew + b - a]
            st = (plcp, p, torch.zeros_like(p))
            trail = []
            for steps in (1, 7, 2048, None):
                taken = torch.zeros(len(p), dtype=torch.int32, device=cuda)
                st = fn(words, phi, p0, st[0], st[1], st[2], pend, n, a,
                        bits, steps=steps, taken=taken)
                trail.append(tuple(x.clone() for x in st) + (taken,))
            states.append(trail)
        for got, ref in zip(*states):
            for x, y in zip(got, ref):
                assert torch.equal(x, y), (kind, where, a)
        np.testing.assert_array_equal(states[0][-1][0].cpu().numpy(),
                                      want[a:b])


def test_kasai_device_route_and_encoder(cuda):
    """``compute_plcp`` on the device route (the doubling's SA kept on the
    card, one launch) and the device encoder against the host's."""
    from bwtb3m_tpu_torch.lcp import plcp as P
    from bwtb3m_tpu_torch.ops import kasai as K
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, (1 << 22) + 5).astype(np.int32)
    before = K.kasai_walk.launches
    plcp, sa = P.compute_plcp(text, 4, device=cuda)
    assert K.kasai_walk.launches == before + 1
    np.testing.assert_array_equal(plcp, P.kasai_plcp(text, sa))
    nbits, by = P.encode_plcp_bits_device(
        torch.from_numpy(plcp.astype(np.int32)).to(cuda))
    bits = P.encode_plcp_bits(plcp)
    assert nbits == len(bits)
    np.testing.assert_array_equal(
        np.unpackbits(by, bitorder="little")[:nbits], bits)


def test_kasai_kernel_refuses_lanes_outside_the_slab(cuda):
    from bwtb3m_tpu_torch.ops import kasai as K
    _t, _sa, words, (phi, p0), p, pend, bits = _kasai_case(
        "dna", 5000, 64, cuda, 1000, 3000)
    plcp = torch.zeros(2000, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="outside the slab"):
        K.kasai_walk(words, phi, p0, plcp, p - 1, torch.zeros_like(p), pend,
                     5000, 1000, bits)
    with pytest.raises(TypeError, match="int32"):
        K.kasai_walk(words.long(), phi, p0, plcp, p, torch.zeros_like(p),
                     pend, 5000, 1000, bits)
    with pytest.raises(ValueError, match="p0"):
        K.kasai_walk(words, phi, 5000, plcp, p, torch.zeros_like(p), pend,
                     5000, 1000, bits)


# ------------------------------------------------ wavelet rows (sigma > 256)
# 12,232 symbols: the most whose D or start shares the 48 KB of shared
# memory with the static digit table of 7 levels; 12,233 and 13,000
# symbols: D and start past that limit, read with __ldg; 65,536 symbols:
# 6 levels, the most of the uint16 form; n = 96k - 1, 96k and 96k + 1
# (the pad block of position n alone, full, and with one digit)
WM_CASES = [(sigma, (1 << 16) + 37)
            for sigma in (300, 5000, 12232, 12233, 13000)] + [
    (sigma, 96_000 + d) for sigma in (5000, 65536) for d in (-1, 0, 1)] + [
    # past 65,536 symbols: uint32 symbols, 6 levels and 7 (D and start in
    # global memory)
    (65537, 96_000), (150_000, 200_003), (1_112_064, 1_200_007)]


def _wm_build(sigma, n, rate, cuda):
    from bwtb3m_tpu_torch.ops.wavelet_rows import build_wavelet_host
    rng = np.random.default_rng(sigma + n)
    text = rng.integers(0, sigma, n).astype(np.int32)
    text[:sigma] = np.arange(sigma)           # every symbol present
    sa, isa, bwt = suffix_array(text, sigma, cuda)
    wm = build_wavelet_host(bwt.astype(np.int32), sigma, cuda)
    pos = np.arange(0, n, rate, dtype=np.int64)
    seg = np.diff(np.r_[pos, n])
    start = (pos + seg) % n
    lanes = [torch.from_numpy(a).to(cuda) for a in (isa[start], start, seg)]
    return text, sa, isa, wm, lanes


@pytest.mark.parametrize("sigma,n", WM_CASES)
def test_lf_walk_wm_kernel_matches_plain(cuda, sigma, n):
    """bwt_lf_walk_wm's final-rank, verify and harvest forms (the uint16
    form up to 65,536 symbols, the uint32 one past them) against the
    plain descent, and the harvest against the sort's SA and ISA."""
    from bwtb3m_tpu_torch.ops.wavelet_rows import as_symbols
    text, sa, isa, wm, (r0, p0, seg) = _wm_build(sigma, n, 64, cuda)
    form = "_wm" if sigma <= 1 << 16 else "_wm32"
    before = dict(lw.LAUNCHES)
    got = lw.lf_walk(wm, r0, 300)
    assert lw.LAUNCHES["none" + form] == before["none" + form] + 1
    assert torch.equal(got, lw.lf_walk_plain(wm, r0, 300))
    t = as_symbols(torch.from_numpy(text).to(cuda), sigma)
    assert int(lw.verify_walk(wm, t, r0, p0, seg).sum()) == 0
    t[1000] = as_symbols(torch.tensor([(text[1000] + 1) % sigma],
                                      device=cuda), sigma)[0]
    bad = lw.verify_walk(wm, t, r0, p0, seg)
    assert lw.LAUNCHES["verify" + form] == before["verify" + form] + 2
    assert torch.equal(bad, lw.verify_walk_plain(wm, t, r0, p0, seg))
    assert int(bad.sum()) == 1
    got = lw.harvest_walk(wm, r0, p0, seg, 32, 48)
    assert lw.LAUNCHES["harvest" + form] == before["harvest" + form] + 1
    want = lw.harvest_walk_plain(wm, r0, p0, seg, 32, 48)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].cpu().numpy(), sa[::32])
    np.testing.assert_array_equal(got[1].cpu().numpy(), isa[::48])


@pytest.mark.parametrize("sigma,n", WM_CASES)
def test_gap_chain_mk_wm_kernel_matches_plain(cuda, sigma, n):
    """bwt_gap_chain_mk_wm's recording and anchor forms against the plain
    version on a merge of [0, m) into [m, n) over 16-bit regions (32-bit
    past 65,536 symbols: the uint32 form), and the recorded ranks against
    the sort's."""
    from bwtb3m_tpu_torch.engine.merge_scaled import host_symbol_dtype
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    from bwtb3m_tpu_torch.ops.devzip import bits_for, pack_region
    from bwtb3m_tpu_torch.ops.wavelet_rows import as_symbols
    rng = np.random.default_rng(sigma * 31 + n)
    text = rng.integers(0, sigma, n).astype(host_symbol_dtype(sigma))
    text[:sigma] = np.arange(sigma)
    m = n // 2
    sa, isa, _bwt = suffix_array(text.astype(np.int32), sigma, cuda)
    right = sa[sa >= m]
    R = np.searchsorted(np.sort(isa[m:]), isa)
    hist = np.bincount(text[m:], minlength=sigma)
    rbwt = as_symbols(torch.from_numpy(
        text[(right - 1) % n].astype(np.int64)).to(cuda), sigma)
    bits = bits_for(sigma)
    form = "_wm" if bits == 16 else "_wm32"
    runner = gb.BatchedGapRunner(
        as_symbols(torch.from_numpy(text.astype(np.int64)).to(cuda), sigma),
        text, sigma, [(0, m, n, int(R[m]), hist)], [pack_region(rbwt, bits)],
        bits, lane_bucket=512, sample_rate=64)
    bounds = np.linspace(0, m, 513).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    runner._ensure_gt([int(starts.max()) + 1])
    kd, st, sd, ln = runner._lanes(np.zeros(len(starts)), starts,
                                   R[(starts + 1) % n], lens)
    args = (runner.focc, runner.text_dev, runner.gt_dev, runner.c_first,
            runner.table, kd, st, sd, ln)
    sp = runner.specs[0]
    outs = []
    for fn in (gb.chain_walk_mk, gb.gap_chain_mk_plain):
        gap = torch.zeros(runner.focc.n + 1, dtype=torch.int32, device=cuda)
        samp = torch.full((sp.nsamp,), -1, dtype=torch.int32, device=cuda)
        before = dict(gb.LAUNCHES)
        final = fn(*args, gap, samp, 64)
        if fn is gb.chain_walk_mk:
            assert gb.LAUNCHES["chain" + form] == before["chain" + form] + 1
        outs.append((final, gap, samp))
    (fk, gk, sk), (fp, gp, sp_) = outs
    assert torch.equal(fk, fp) and torch.equal(gk, gp) \
        and torch.equal(sk, sp_)
    np.testing.assert_array_equal(sk.cpu().numpy(), R[0:m:64])
    np.testing.assert_array_equal(
        gk.cpu().numpy(), np.bincount(R[:m], minlength=runner.focc.n + 1))
    for r0 in (0, sp.gap_size):
        sd0 = torch.full_like(sd, r0)
        before = gb.LAUNCHES["anchor" + form]
        a = gb.anchor_walk_mk(*args[:7], sd0, ln)
        assert gb.LAUNCHES["anchor" + form] == before + 1
        assert torch.equal(a, gb.gap_chain_mk_plain(*args[:7], sd0, ln))
    # the runner's own anchors and chains give the sort's ranks
    runner.compute()
    np.testing.assert_array_equal(
        runner.gap.cpu().numpy(),
        np.bincount(R[:m], minlength=runner.focc.n + 1))


# ------------------------------------- the locate and decode visits (FM index)

LOCATE_ROWS = ([("narrow", s, lay) for s, lay in ROWS]
               + [("wide", 4, "sector"), ("wide", 7, "bitplane"),
                  ("wide", 200, "bytes")]
               + [("wavelet", s, "wavelet")
                  for s in (300, 5000, 65536, 150_000, 1_112_064)])


def _index_rows(kind, sigma, layout, cuda):
    """(text, sa, isa, rows) at n = 2^16 + 37 of each family: narrow rows,
    wide rows doctored across 2^32, wavelet rows (n = sigma + 37 past
    that: every symbol present)."""
    n = max((1 << 16), sigma) + 37
    if kind == "wavelet":
        text, sa, isa, wm, _lanes = _wm_build(sigma, n, 64, cuda)
        return text, sa, isa, wm
    text, sa, isa, focc, _lanes = _build(sigma, n, 64, cuda, layout)
    if kind == "wide":
        return text, sa, isa, _doctored(focc, text[(sa - 1) % n], sigma,
                                        layout, cuda)
    return text, sa, isa, focc


@pytest.mark.parametrize("kind,sigma,layout", LOCATE_ROWS)
@pytest.mark.parametrize("rate", [32, 7, 1])
def test_locate_kernel_matches_plain(cuda, kind, sigma, layout, rate):
    """The locate visit (``locate_walk``) in each kernel form against its
    plain version, rank and steps, at a power-of-two rate, another rate
    and rate 1 (no step), on 20,002 lanes and on 2^19, more than the
    card holds at once; the SA it gives against the sort's."""
    text, sa, isa, rows = _index_rows(kind, sigma, layout, cuda)
    n = len(text)
    rng = np.random.default_rng(rate + sigma)
    form = "_wm" if sigma <= 1 << 16 else "_wm32"
    key = {"narrow": "locate", "wide": "locate64", "wavelet": "locate" + form}[kind]
    for nl in (20000, 1 << 19):
        r0 = torch.from_numpy(np.r_[0, n - 1, rng.integers(0, n, nl)]).to(
            cuda)
        before = lw.LAUNCHES[key]
        r, steps = lw.locate_walk(rows, r0, rate)
        assert lw.LAUNCHES[key] == before + 1
        pr, psteps = lw.locate_walk_plain(rows, r0, rate)
        assert torch.equal(r, pr) and torch.equal(steps, psteps)
        assert int(steps.min()) >= 0 and bool((r % rate == 0).all())
        got = (sa[r.cpu().numpy()] + steps.cpu().numpy()) % n
        np.testing.assert_array_equal(got, sa[r0.cpu().numpy()])
    # the BWT of a square u.u is BWT(u) with each symbol doubled: its LF
    # keeps even and odd ranks apart, so at rate 4 the even lanes walk to
    # a multiple of 4 and the odd ones meet none and end after n steps
    # with -1, in both
    m, sig = 301, min(sigma, 300)
    u = np.random.default_rng(sigma).integers(0, sig, m)
    u[:sig] = np.arange(sig)
    _sa, _isa, bwt_u = suffix_array(u.astype(np.int32), sig, cuda)
    bwt2 = np.repeat(np.asarray(bwt_u), 2)
    if kind == "wavelet":
        from bwtb3m_tpu_torch.ops.wavelet_rows import build_wavelet_host
        sq = build_wavelet_host(bwt2.astype(np.int32), sig, cuda)
    else:
        sq = build_focc_host(bwt2.astype(np.uint8), sig, cuda, layout)
        if kind == "wide":
            sq = _doctored(sq, bwt2.astype(np.uint8), sig, layout, cuda)
    # every rank, then 2^19 seeded ones: lanes of -1 among lanes that
    # meet a sampled rank, in every block
    for r0 in (torch.arange(2 * m, device=cuda),
               torch.from_numpy(rng.integers(0, 2 * m, 1 << 19)).to(cuda)):
        r, steps = lw.locate_walk(sq, r0, 4)
        pr, psteps = lw.locate_walk_plain(sq, r0, 4)
        assert torch.equal(r, pr) and torch.equal(steps, psteps)
        assert torch.equal(steps < 0, r0 % 2 == 1)


@pytest.mark.parametrize("kind,sigma,layout", LOCATE_ROWS)
def test_decode_kernel_matches_plain(cuda, kind, sigma, layout):
    """The decode visit (``decode_walk``) in each kernel form against its
    plain version on the FM index's lanes of several ranges (one across
    the end of the text, one of n symbols): the ISA samples' lanes
    (``decode_lanes``) and the SA samples' (``decode_lanes_sa``, built on
    the card, thousands of lanes); and ``FMIndex.extract`` (one launch)
    and ``locate_batch`` on the card against the text and the SA."""
    from bwtb3m_tpu_torch.index.fm import FMIndex, decode_lanes
    from bwtb3m_tpu_torch.index.sampled import SampledISA, SampledSA
    text, sa, isa, rows = _index_rows(kind, sigma, layout, cuda)
    n = len(text)
    fm = FMIndex(None, sigma, n, SampledSA(32, sa[::32], n),
                 SampledISA(1000, isa[::1000], n), device=cuda, rows=rows)
    form = "_wm" if sigma <= 1 << 16 else "_wm32"
    key = {"narrow": "decode", "wide": "decode64", "wavelet": "decode" + form}[kind]
    for start, length in ((0, 5000), (n - 700, 2000), (12345, n), (17, 1)):
        isa_lanes = [torch.from_numpy(a).to(cuda)
                     for a in decode_lanes(fm.isa, n, start, length)]
        sa_lanes = fm.decode_plan(start, length)
        assert sa_lanes[0].is_cuda and len(sa_lanes[0]) > len(isa_lanes[0])
        for r0, p0, seg in (isa_lanes, sa_lanes):
            before = lw.LAUNCHES[key]
            got = lw.decode_walk(rows, r0, p0, seg, start, length)
            assert lw.LAUNCHES[key] == before + 1
            assert torch.equal(got, lw.decode_walk_plain(rows, r0, p0, seg,
                                                         start, length))
        before = lw.LAUNCHES[key]
        np.testing.assert_array_equal(
            fm.extract(start, length),
            np.take(text, (start + np.arange(length)) % n))
        assert lw.LAUNCHES[key] == before + 1
    ranks = np.random.default_rng(sigma).integers(0, n, 5000)
    np.testing.assert_array_equal(fm.locate_batch(ranks), sa[ranks])


@pytest.mark.parametrize("sigma", [300, 5000, 65536, 300_000])
def test_rank_all_symbols_batch_on_card(cuda, sigma):
    """``ops/rank.py::rank_all_symbols_batch`` (torch, the level walk over
    wavelet rows) on the card: every column the per-symbol ``rank`` of
    the same rows, and the CPU's result."""
    from bwtb3m_tpu_torch.ops import wavelet_rows as wr
    from bwtb3m_tpu_torch.ops.rank import rank_all_symbols_batch
    n = 20011
    rng = np.random.default_rng(sigma)
    bwt = rng.integers(0, sigma, n).astype(np.int32)
    pos = np.r_[0, n, 95, 96, 97, rng.integers(0, n + 1, 59)]
    wm = wr.build_wavelet_host(bwt, sigma, cuda)
    got = rank_all_symbols_batch(wm, torch.from_numpy(pos).to(cuda))
    assert got.is_cuda
    i = torch.from_numpy(pos).to(cuda).repeat_interleave(sigma)
    c = torch.arange(sigma, device=cuda).repeat(len(pos))
    assert torch.equal(got, wr.rank(wm, c, i).view(len(pos), sigma))
    cpu = rank_all_symbols_batch(wr.build_wavelet_host(bwt, sigma, "cpu"),
                                 torch.from_numpy(pos))
    assert torch.equal(got.cpu(), cpu)


def test_fasta_pipeline_and_merge_legacy_on_card(cuda, tmp_path):
    """fagzToCompact4, then ``bwtb3m inputtype=compactstream`` on the card
    with ``engine=merge-legacy``, ``merge`` and ``doubling`` (the same
    .bwt/.hist/.preisa bytes), ``bwtcomputessa`` and
    ``fa4suffixarraytocompact``, whose coordinates decode to the .sa."""
    import gzip
    from bwtb3m_tpu_torch.cli import dispatch
    from bwtb3m_tpu_torch.cli.prep import read_compact4_meta
    from bwtb3m_tpu_torch.io import compact, formats
    rng = np.random.default_rng(8)
    seqs = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), 20000,
                       p=[.24, .24, .24, .24, .04]).tobytes()
            for _ in range(3)]
    fa = str(tmp_path / "g.fa.gz")
    with gzip.open(fa, "wb") as f:
        for k, s in enumerate(seqs):
            f.write(b">r%d\n%s\n" % (k, s))
    c4 = str(tmp_path / "g.c4")
    assert dispatch(["fagzToCompact4", "verbose=0", "outputfilename=" + c4,
                     fa]) == 0
    bwts = {}
    for eng in ("merge-legacy", "merge", "doubling"):
        bwts[eng] = str(tmp_path / ("%s.bwt" % eng))
        assert dispatch(["bwtb3m", "inputtype=compactstream", "bwtonly=1",
                         "verbose=0", "device=cuda", "engine=" + eng,
                         "mem=65536", "outputfilename=" + bwts[eng],
                         c4]) == 0
    for ext in (".bwt", ".hist", ".preisa"):
        got = {open(b[:-4] + ext, "rb").read() for b in bwts.values()}
        assert len(got) == 1, ext
    bwt = bwts["merge-legacy"]
    assert dispatch(["bwtcomputessa", "sasamplingrate=8", "verbose=0",
                     "device=cuda", bwt]) == 0
    out = str(tmp_path / "g.fa4c")
    assert dispatch(["fa4suffixarraytocompact", "verbose=0",
                     "outputfilename=" + out, bwt[:-4] + ".sa",
                     c4 + ".meta"]) == 0
    lens = np.array([s for s, _ in read_compact4_meta(c4 + ".meta")])
    coords, _bits = compact.read_compact(out)
    obits = max(1, int(lens.max() - 1).bit_length())
    _rate, sa = formats.read_sampled_array(bwt[:-4] + ".sa")
    np.testing.assert_array_equal(
        np.r_[0, np.cumsum(lens)][coords >> obits]
        + (coords & ((1 << obits) - 1)), sa)


def test_nccl_group_of_one(cuda):
    """A group of one on the card runs over NCCL: its collectives and a
    self exchange on card tensors, and the sharded sort against the
    single-card sort."""
    from bwtb3m_tpu_torch.parallel import dist, sharded_bwt
    from bwtb3m_tpu_torch.parallel import mesh as pm
    from bwtb3m_tpu_torch.parallel.blocksort import exchange
    text = np.random.default_rng(9).integers(0, 4, 100_003).astype(np.int32)
    with dist.session("cuda") as mesh:
        assert (mesh.world, mesh.backend) == (1, "nccl")
        assert mesh.device.type == "cuda" and not mesh.staged
        t = torch.arange(1 << 16, device=mesh.device)
        assert torch.equal(pm.all_reduce(mesh, t.clone(), "sum"), t)
        assert torch.equal(pm.all_gather(mesh, t), t[None])
        assert torch.equal(pm.broadcast(mesh, t.clone(), 0), t)
        got, = exchange(mesh, [t], [(0, 0)])
        assert torch.equal(got, t)
        sa, _rank, bwt = sharded_bwt(text, 4, mesh)
    assert not torch.distributed.is_initialized()
    sa1, _isa, bwt1 = suffix_array(text, 4, cuda)
    assert np.array_equal(sa, sa1) and np.array_equal(bwt, bwt1)


def test_lane_sharded_level_on_two_ranks_sharing_the_card(cuda):
    """Two ranks on the one card (gloo, collectives staged through the
    host): the scaled build with its first level's lanes cut over the
    ranks and with its pair merges' rows sharded by rank range, against
    the single-card build; each rank launches the gap-chain kernel on its
    lanes, and on rank 1 the kernel equals its plain version there."""
    from bwtb3m_tpu_torch.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.parallel import dist, dryrun
    n = (1 << 18) + 37
    text = np.random.default_rng(10).integers(0, 4, n, dtype=np.uint8)
    block, rate, lanes = n // 5 + 1, 512, 1024
    calls = [("scaled_cases", (text, 4, block, rate, lanes,
                               [{}, {"BWTB3M_SHARD_OCC": "1"}])),
             ("level_on_lane_parts", (text, 4, block, rate, lanes, 1, 1))]
    ranks = dist.run_ranks(dryrun.run_jobs, 2, (calls,), device="cuda",
                           timeout=300)
    want = blockwise_bwt_scaled(
        text, 4, BwtOptions(input_path="<mem>", output_filename="x",
                            max_block_symbols=block, verbose=0),
        sample_rate=rate, lane_bucket=lanes, device=cuda)
    for rank, (builds, level) in enumerate(ranks):
        launches = builds["launches"]
        for got, _msgs, _walls in builds["result"]:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert launches["gap_chain"]["chain"] >= 1
        assert launches["gap_chain"]["anchor"] >= 1
        n_lanes, check = level["result"]
        if rank == 1:
            compared, kernel_launches, same = check
            assert compared > 0 and kernel_launches == 1 and same
