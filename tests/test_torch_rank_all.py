"""``ops/rank.py::rank_all_symbols_batch`` against the reference's.

The port computes every symbol's rank at a batch of positions over its
own rows; the reference's ``bwtb3m_tpu.ops.rank.rank_all_symbols_batch``
over ``build_occ`` of the same BWT is the oracle, run on the CPU as the
reference's tests run it.  Wavelet rows at sigma 300, 5,000 and 65,536
(built over the full alphabet, and compacted to the present symbols with
the map back), the sector, bit-plane and byte rows, and the wide rows
(doctored across 2^32) against the port's plain per-symbol rank.
Positions: 0, n, the block edges of both layouts and random ones.
Exact equality: the ranks are integer.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from bwtb3m_tpu.ops.rank import build_occ
from bwtb3m_tpu.ops.rank import rank_all_symbols_batch as jax_rank_all
from bwtb3m_tpu_torch.ops import lf, wavelet_rows as wr
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from bwtb3m_tpu_torch.ops.rank import rank_all_symbols_batch
from bwtb3m_tpu_torch.ops.wideocc import doctored

torch.set_num_threads(1)


def _positions(n, seed, k):
    """0, n, the edges of 64-, 96-, 128- and 256-symbol blocks inside
    [0, n] and ``k`` random positions."""
    edges = np.concatenate([np.arange(b, n, b * 7)[:, None] + [-1, 0, 1]
                            for b in (64, 96, 128, 256)]).reshape(-1)
    rng = np.random.default_rng(seed)
    pos = np.concatenate([[0, n], edges, rng.integers(0, n + 1, k)])
    return pos[(pos >= 0) & (pos <= n)].astype(np.int32)


def _reference(bwt, sigma, pos, group):
    """The reference's ranks, ``group`` positions a call (its
    [B, 128, sigma] intermediate is what bounds the group)."""
    occ = build_occ(bwt, sigma)
    return np.concatenate([
        np.asarray(jax_rank_all(occ, jnp.asarray(pos[a:a + group])))
        for a in range(0, len(pos), group)])


@pytest.mark.parametrize("compacted", [False, True])
@pytest.mark.parametrize("sigma,n,k,group", [(300, 20011, 300, 128),
                                             (5000, 20011, 200, 64),
                                             (65536, 3001, 24, 8)])
def test_wavelet_rows_equal_occtable(sigma, n, k, group, compacted):
    rng = np.random.default_rng(sigma + n)
    bwt = rng.integers(0, sigma, n).astype(np.int32)
    if compacted:
        bwt[bwt % 3 == 1] = 0           # a third of the alphabet absent
    bwt[:2] = [0, sigma - 1]
    pos = _positions(n, sigma, k)
    want = _reference(bwt, sigma, pos, group)
    if compacted:
        symmap, dense = np.unique(bwt, return_inverse=True)
        wm = wr.build_wavelet_host(dense.astype(np.int32), len(symmap), "cpu")
        got = rank_all_symbols_batch(wm, torch.from_numpy(pos), symmap,
                                     sigma)
        assert len(symmap) < sigma
    else:
        wm = wr.build_wavelet_host(bwt, sigma, "cpu")
        got = rank_all_symbols_batch(wm, torch.from_numpy(pos))
    assert got.dtype == torch.int64 and tuple(got.shape) == (len(pos), sigma)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wavelet_level_walk_equals_descents():
    """Small chunks (one position a group) and per-symbol descents give
    the same ranks as one group."""
    sigma, n = 600, 4001
    rng = np.random.default_rng(3)
    wm = wr.build_wavelet_host(rng.integers(0, sigma, n).astype(np.int32),
                               sigma, "cpu")
    pos = torch.from_numpy(_positions(n, 3, 40)).long()
    one = wr.rank_all(wm, pos)
    assert torch.equal(wr.rank_all(wm, pos, chunk=1), one)
    c = torch.arange(sigma).repeat(len(pos))
    i = pos.repeat_interleave(sigma)
    assert torch.equal(wr.rank(wm, c, i).view(len(pos), sigma), one)


@pytest.mark.parametrize("sigma,layout", [(4, "sector"), (4, "bitplane"),
                                          (7, "bitplane"), (200, "bytes"),
                                          (256, "bytes")])
def test_narrow_rows_equal_occtable(sigma, layout):
    n = 9001
    rng = np.random.default_rng(sigma)
    bwt = rng.integers(0, sigma, n).astype(np.int32)
    pos = _positions(n, sigma, 400)
    want = _reference(bwt, sigma, pos, 512)
    rows = build_focc_host(bwt.astype(np.uint8), sigma, "cpu", layout)
    assert rows.LAYOUT == layout
    got = rank_all_symbols_batch(rows, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sigma,layout", [(4, "sector"), (7, "bitplane"),
                                          (200, "bytes")])
def test_wide_rows_equal_plain_rank(sigma, layout):
    """Rows doctored so that every count crosses 2^32 halfway: each column
    is the plain 64-bit rank of its symbol, past 2^32."""
    n = 5003
    rng = np.random.default_rng(sigma + 1)
    bwt = rng.integers(0, sigma, n)
    cnt = np.bincount(bwt, minlength=sigma)
    w = doctored(torch.from_numpy(bwt.astype(np.uint8)), sigma, layout,
                 torch.from_numpy(((1 << 32) - cnt // 2).astype(np.int64)))
    pos = torch.from_numpy(_positions(n, sigma, 100)).long()
    got = rank_all_symbols_batch(w, pos)
    c = torch.arange(sigma).repeat(len(pos))
    want = lf.rank(w, c, pos.repeat_interleave(sigma)).view(len(pos), sigma)
    assert torch.equal(got, want)
    assert int(got[1].min()) >= 1 << 32       # position n


def test_unknown_rows_raise():
    with pytest.raises(ValueError, match="wavelet, sector, bit-plane"):
        rank_all_symbols_batch(type("Rows", (), {"C": torch.zeros(1)})(),
                               torch.zeros(1, dtype=torch.int64))
