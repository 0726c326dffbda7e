"""The LF-walk and gap-chain CUDA kernels, through each of their entry
points and on each rank-row layout (sector, bit-plane, bytes), against the
plain PyTorch versions, on the card.  Skipped without a CUDA device; on
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
    """A merge of [0, m) into [m, n): the right region's rank rows from
    the sorted rotations of [m, n), lanes over the left block seeded
    from the sort (so every chain is exact), the runner's own inputs."""
    from bwtb3m_tpu_torch.ops.gapdev import GapRunner
    rng = np.random.default_rng(sigma * 31 + n)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    m = n // 2
    sa, isa, _bwt = suffix_array(text, sigma, "cpu")
    right = sa[sa >= m]                          # rotation order of M
    rbwt = text[(right - 1) % n]
    rank_in_m = np.searchsorted(np.sort(isa[m:]), isa)   # R(p)
    focc = build_focc_host(rbwt, sigma, cuda, layout)
    hist = np.bincount(text[m:], minlength=sigma)
    runner = GapRunner(focc, torch.from_numpy(text).to(cuda), text, 0, m,
                       n, int(rank_in_m[m]), hist, sample_rate=64)
    bounds = np.linspace(0, m, lanes + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = rank_in_m[(starts + 1) % n]
    return runner, starts, seeds, lens, rank_in_m


@pytest.mark.parametrize("sigma,layout", ROWS)
def test_gap_chain_kernel_matches_plain(cuda, sigma, layout):
    from bwtb3m_tpu_torch.ops import gapdev as gd
    runner, starts, seeds, lens, R = _gap_case(sigma, (1 << 16) + 37, cuda,
                                              layout)
    runner.ensure_gt(int(starts.max()) + 1)
    st, sd, ln = runner._lanes(starts, seeds, lens)
    args = (runner.focc, runner.text_dev, runner.gt_dev, runner.lo0,
            runner.c_first, runner.consts, st, sd, ln)
    m = runner.m
    outs = []
    for fn in (gd.chain_walk, gd.gap_chain_plain):
        gap = torch.zeros(runner.gap_size + 1, dtype=torch.int32,
                          device=cuda)
        samp = torch.full((len(range(0, m, 64)),), -1, dtype=torch.int32,
                          device=cuda)
        before = dict(gd.LAUNCHES)
        final = fn(*args, gap, samp, 0, 64)
        if fn is gd.chain_walk:
            assert gd.LAUNCHES["chain"] == before["chain"] + 1
        outs.append((final, gap, samp))
    (fk, gk, sk), (fp, gp, sp) = outs
    assert torch.equal(fk, fp) and torch.equal(gk, gp) and torch.equal(sk, sp)
    np.testing.assert_array_equal(sk.cpu().numpy(), R[0:m:64])
    np.testing.assert_array_equal(
        gk.cpu().numpy(), np.bincount(R[:m], minlength=runner.gap_size + 1))
    # the anchor form from both bounds
    for r0 in (0, runner.gap_size):      # a seed r = n reads the last row
        sd0 = torch.full_like(sd, r0)
        a = gd.anchor_walk(*args[:7], sd0, ln)
        b = gd.gap_chain_plain(*args[:7], sd0, ln)
        assert torch.equal(a, b)


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
