"""The port's LF walks (plain versions, on the CPU) against the reference.

``lf_walk`` is held against the reference's Pallas kernel
``lf_walk_pallas`` run in interpret mode, as tests/test_lf_pallas.py runs
it, and against ``ops/lf.py::lf_walk``.  ``verify_walk`` and
``harvest_walk`` are held against a naive SA.  Every test runs on each
rank-row layout that holds its alphabet (sector rows for sigma <= 4,
bit-plane rows for sigma <= 8, byte rows), so the plain version of each
kernel is held to the reference on the rows its kernel reads.  Every
comparison is exact.  The wrappers take the plain version for CPU
tensors, so no launch is counted here.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from bwtb3m_tpu.ops.lf import lf_walk as lf_walk_xla
from bwtb3m_tpu.ops.lf_pallas import lf_walk_pallas
from bwtb3m_tpu.ops.rank import build_occ
from bwtb3m_tpu.ops.rank_packed import build_occ_packed
from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from oracle import naive_circular_sa, random_string


LAYOUTS4 = ["sector", "bitplane", "bytes"]


@pytest.mark.parametrize("sigma,layout", [(4, lay) for lay in LAYOUTS4]
                         + [(2, "sector"), (7, "bitplane"), (200, "bytes")])
def test_lf_walk_matches_pallas_interpret_and_xla(sigma, layout):
    n = 4000 + sigma            # not a multiple of 64
    bwt = random_string(n, sigma, seed=2 + sigma)
    r0 = np.arange(0, n, 11).astype(np.int32)
    want_pallas = np.asarray(lf_walk_pallas(build_occ_packed(bwt, sigma),
                                            jnp.asarray(r0), 64, True))
    want_xla, _ = lf_walk_xla(build_occ(bwt, sigma), jnp.asarray(r0), 64)
    np.testing.assert_array_equal(want_pallas, np.asarray(want_xla))
    focc = build_focc_host(bwt.astype(np.uint8), sigma, "cpu", layout)
    assert focc.LAYOUT == layout
    lw.reset_launch_counts()
    got = lw.lf_walk(focc, torch.from_numpy(r0.astype(np.int64)), 64)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    assert lw.lf_walk.launches == 0


@pytest.mark.parametrize("sigma,n", [(1, 1), (1, 64), (2, 63), (3, 64),
                                     (4, 65), (4, 129)])
def test_lf_walk_on_sector_rows_at_block_edges(sigma, n):
    # every rank of a BWT of one block, one block and a symbol, ...: the
    # XLA walk of the reference on the same BWT, 2n steps
    bwt = random_string(n, sigma, seed=n + sigma)
    r0 = np.arange(n)
    want, _ = lf_walk_xla(build_occ(bwt, sigma),
                          jnp.asarray(r0.astype(np.int32)), 2 * n)
    for layout in ("sector", "bitplane"):
        focc = build_focc_host(bwt.astype(np.uint8), sigma, "cpu", layout)
        got = lw.lf_walk(focc, torch.from_numpy(r0), 2 * n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _text_and_bwt(n, sigma, seed):
    text = random_string(n, sigma, seed)
    sa = naive_circular_sa(text)
    return text, sa, text[(sa - 1) % n]


def _seeds(sa, n, rate):
    isa = np.empty(n, np.int64)
    isa[sa] = np.arange(n)
    pos = np.arange(0, n, rate, dtype=np.int64)
    seg = np.diff(np.r_[pos, n])           # lane i walks back from pos[i+1]
    # lane i starts at position (pos[i] + seg[i]) % n: lane 0 is the wrap
    start = (pos + seg) % n
    return (torch.from_numpy(isa[start]), torch.from_numpy(start),
            torch.from_numpy(seg))


WALK_CASES = ([(4, 64, lay) for lay in LAYOUTS4] + [(200, 50, "bytes")]
              + [(4, 700, lay) for lay in LAYOUTS4] + [(3, 64, "sector")])


@pytest.mark.parametrize("sigma,rate,layout", WALK_CASES)
def test_verify_walk_counts_mismatches(sigma, rate, layout):
    n = 700
    text, sa, bwt = _text_and_bwt(n, sigma, seed=sigma + rate)
    focc = build_focc_host(bwt.astype(np.uint8), sigma, "cpu", layout)
    r0, p0, seg = _seeds(sa, n, rate)
    t = torch.from_numpy(text.astype(np.uint8))
    assert int(lw.verify_walk(focc, t, r0, p0, seg).sum()) == 0
    bad_text = t.clone()
    bad_text[123] = (bad_text[123] + 1) % sigma
    bad = lw.verify_walk(focc, bad_text, r0, p0, seg)
    assert int(bad.sum()) == 1


@pytest.mark.parametrize(
    "sigma,rate,sarate,isarate,layout",
    [(4, 64, 16, 48, lay) for lay in LAYOUTS4] + [(200, 50, 7, 5, "bytes")]
    + [(4, 700, 32, 1024, lay) for lay in LAYOUTS4]
    + [(2, 64, 1, 1, "sector")])
def test_harvest_walk_matches_sa(sigma, rate, sarate, isarate, layout):
    n = 700
    _text, sa, bwt = _text_and_bwt(n, sigma, seed=3 * sigma + rate)
    focc = build_focc_host(bwt.astype(np.uint8), sigma, "cpu", layout)
    r0, p0, seg = _seeds(sa, n, rate)
    sa_s, isa_s = lw.harvest_walk(focc, r0, p0, seg, sarate, isarate)
    isa = np.empty(n, np.int64)
    isa[sa] = np.arange(n)
    np.testing.assert_array_equal(sa_s.numpy(), sa[::sarate])
    np.testing.assert_array_equal(isa_s.numpy(), isa[::isarate])


def test_walks_without_lanes():
    focc = build_focc_host(np.zeros(10, np.uint8), 1, "cpu")
    empty = torch.zeros(0, dtype=torch.int64)
    assert len(lw.lf_walk(focc, empty, 5)) == 0
    assert len(lw.verify_walk(focc, torch.zeros(10, dtype=torch.uint8),
                              empty, empty, empty)) == 0
