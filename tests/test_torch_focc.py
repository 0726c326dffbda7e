"""The port's rank rows and plain queries against the reference package's.

In the reference's own layouts (``layout="bitplane"`` for sigma <= 8,
``"bytes"`` above) rows 0..nb and C of
``bwtb3m_tpu_torch.ops.focc_build.build_focc_host`` must be
byte-identical to ``bwtb3m_tpu.ops.focc_build.build_focc_host``.  In
every layout, the port's sector rows (sigma <= 4, what ``"auto"`` gives
there) included, the plain ``rank`` / ``access`` / ``lf_step`` queries
must equal the reference's ``*_batch_f`` queries (which reach
``rank_batch_bp`` / ``lf_step_batch_bp`` on bit-plane rows) on the same
BWT (integers: tolerance 0).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from bwtb3m_tpu.ops.focc import access_batch_f, lf_step_batch_f, rank_batch_f
from bwtb3m_tpu.ops.focc_build import build_focc_host as build_jax
from bwtb3m_tpu_torch.ops import focc as pfocc
from bwtb3m_tpu_torch.ops.focc import FusedOcc
from bwtb3m_tpu_torch.ops.focc_bp import (FusedOccBP, FusedOccSector,
                                          popcount32, prefix_mask)
from bwtb3m_tpu_torch.ops.focc_build import (build_focc_host, focc_from_jax,
                                             resolve_layout)

CASES = [(1, 1000), (4, 5000), (4, 4096), (8, 100), (9, 3000), (200, 2560),
         (200, 777)]
# sector rows: n not a multiple of 64, n = 1, n around one block, sigma 1..4
SECTOR_CASES = [(1, 1), (1, 63), (2, 64), (3, 65), (4, 127), (4, 128),
                (4, 129), (2, 1000), (3, 4096), (4, 5000)]
TYPES = {"sector": FusedOccSector, "bitplane": FusedOccBP, "bytes": FusedOcc}


def _layouts(sigma):
    return [k for k, cls in TYPES.items() if sigma <= cls.MAX_SIGMA]


LAYOUT_CASES = ([(s, n, lay) for s, n in CASES for lay in _layouts(s)]
                + [(s, n, "sector") for s, n in SECTOR_CASES
                   if (s, n) not in CASES])


def _bwt(sigma, n):
    rng = np.random.default_rng(sigma * 7919 + n)
    return rng.integers(0, sigma, n).astype(np.uint8)


def _own_layout(sigma):
    """The reference's layout for this alphabet."""
    return "bitplane" if sigma <= 8 else "bytes"


@pytest.mark.parametrize("sigma,n", CASES)
def test_rows_byte_identical(sigma, n):
    bwt = _bwt(sigma, n)
    ref = build_jax(bwt, sigma)
    got = build_focc_host(bwt, sigma, "cpu", _own_layout(sigma))
    assert type(got) is (FusedOccBP if sigma <= 8 else FusedOcc)
    nb = (n + 255) // 256
    want_rows = np.asarray(ref.rows).view(np.uint8)[:nb + 1]
    np.testing.assert_array_equal(got.rows.numpy(), want_rows)
    np.testing.assert_array_equal(got.C.numpy().astype(np.uint32),
                                  np.asarray(ref.C))
    assert (got.n, got.sigma) == (n, sigma)


@pytest.mark.parametrize("sigma,n", CASES + SECTOR_CASES[:7])
def test_auto_takes_the_narrowest_layout(sigma, n):
    got = build_focc_host(_bwt(sigma, n), sigma, "cpu")
    want = "sector" if sigma <= 4 else _own_layout(sigma)
    assert resolve_layout("auto", sigma) == want == got.LAYOUT
    assert type(got) is TYPES[want]
    assert got.rows.shape == (got.num_rows(n), got.rows.shape[1])
    if want == "sector":        # n/2 bytes, and the row of i == n exists
        assert got.rows.shape == (n // 64 + 1, 32)
    assert got.C.numpy().tolist() == np.r_[0, np.cumsum(np.bincount(
        _bwt(sigma, n), minlength=sigma))].tolist()


@pytest.mark.parametrize("layout,sigma", [("sector", 5), ("bitplane", 9),
                                          ("bytes", 257), ("auto", 257),
                                          ("rows", 4)])
def test_layout_refuses_what_it_cannot_hold(layout, sigma):
    with pytest.raises(ValueError):
        resolve_layout(layout, sigma)


@pytest.mark.parametrize("sigma,n,layout",
                         [(4, 5000, "auto"), (200, 2560, "auto"),
                          (4, 5000, "bitplane"), (3, 65, "sector"),
                          (8, 100, "bytes"), (4, 1, "auto")])
def test_focc_from_jax_round_trip(sigma, n, layout):
    bwt = _bwt(sigma, n)
    carried = focc_from_jax(build_jax(bwt, sigma), layout=layout)
    built = build_focc_host(bwt, sigma, "cpu", layout)
    assert type(carried) is type(built)
    assert torch.equal(carried.rows, built.rows)
    assert torch.equal(carried.C, built.C)
    assert (carried.n, carried.sigma) == (built.n, built.sigma)


@pytest.mark.parametrize("sigma,n,layout", LAYOUT_CASES)
def test_plain_queries_match_jax(sigma, n, layout):
    bwt = _bwt(sigma, n)
    ref = build_jax(bwt, sigma)
    got = build_focc_host(bwt, sigma, "cpu", layout)
    assert got.LAYOUT == layout
    rng = np.random.default_rng(n)
    # every block edge (offsets 0, 31, 32, 33, 63 of the sector's words)
    edges = np.array([e for e in (0, 1, 31, 32, 33, 63, 64, 65, 255, 256,
                                  n - 1, n) if 0 <= e <= n])
    qs = np.r_[rng.integers(0, n + 1, 300), edges].astype(np.int64)
    cs = rng.integers(0, sigma, len(qs)).astype(np.int64)
    ps = np.r_[rng.integers(0, n, 300), edges[edges < n]].astype(np.int64)
    want = rank_batch_f(ref, jnp.asarray(cs, jnp.int32),
                        jnp.asarray(qs, jnp.uint32))
    np.testing.assert_array_equal(
        pfocc.rank(got, torch.from_numpy(cs), torch.from_numpy(qs)).numpy(),
        np.asarray(want))
    want = access_batch_f(ref, jnp.asarray(ps, jnp.uint32))
    np.testing.assert_array_equal(
        pfocc.access(got, torch.from_numpy(ps)).numpy(), np.asarray(want))
    s_ref, r_ref = lf_step_batch_f(ref, jnp.asarray(ps, jnp.uint32))
    s_got, r_got = pfocc.lf_step(got, torch.from_numpy(ps))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(r_got.numpy(), np.asarray(r_ref))


def test_plane_words_with_top_bit_keep_their_pattern():
    # symbol 7 everywhere sets every plane bit: words 0xFFFFFFFF must
    # survive as uint32 bit patterns in the uint8 rows
    bwt = np.full(600, 7, np.uint8)
    got = build_focc_host(bwt, 8, "cpu")
    words = got.rows.numpy().view(np.uint32)
    assert (words[:2, :24] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(
        got.rows.numpy(), np.asarray(build_jax(bwt, 8).rows).view(
            np.uint8)[:4])


def test_sector_plane_words_with_top_bit_and_every_offset():
    # symbol 3 everywhere sets both planes to 0xFFFFFFFF (words >= 2^31),
    # and rank(3, i) = i pins the mask at every offset, 0 and 32 included
    n = 200
    got = build_focc_host(np.full(n, 3, np.uint8), 4, "cpu")
    assert got.LAYOUT == "sector"
    words = got.rows.numpy().view(np.uint32)
    assert (words[:3, :4] == 0xFFFFFFFF).all()
    assert words[3, :4].tolist() == [0xFF, 0, 0xFF, 0]      # 8 symbols left
    assert words[:, 7].tolist() == [0, 64, 128, 192]
    i = torch.arange(n + 1)
    for c in range(4):
        want = i if c == 3 else torch.zeros_like(i)
        assert torch.equal(pfocc.rank(got, torch.full_like(i, c), i), want)
    sym, r2 = pfocc.lf_step(got, i[:n])
    assert torch.equal(sym, torch.full((n,), 3)) and torch.equal(r2, i[:n])


def test_sector_occ_words_near_2_32():
    # occ checkpoints are uint32 words: counts above 2^31 must not come
    # back negative or truncated from the uint8 rows
    got = build_focc_host(_bwt(4, 130), 4, "cpu")
    big = 0xFFFFFF00
    words = got.rows.numpy().view(np.uint32)
    base = words[:, 4:8].copy()
    words[:, 4:8] += np.uint32(big)
    q = torch.tensor([0, 1, 64, 65, 129, 130])
    for c in range(4):
        cs = torch.full_like(q, c)
        got_r = pfocc.rank(got, cs, q)
        words[:, 4:8] = base
        assert torch.equal(got_r, pfocc.rank(got, cs, q) + big)
        words[:, 4:8] += np.uint32(big)


def test_prefix_mask_and_popcount_edges():
    off = torch.tensor([0, 1, 31, 32, 33, 255, 256])
    m = prefix_mask(off, 8)
    assert m[0].tolist() == [0] * 8
    assert m[1].tolist() == [1] + [0] * 7
    assert m[3].tolist() == [0xFFFFFFFF] + [0] * 7
    assert m[4].tolist() == [0xFFFFFFFF, 1] + [0] * 6
    assert m[6].tolist() == [0xFFFFFFFF] * 8
    m2 = prefix_mask(torch.tensor([0, 32, 33, 63]), 2)     # a sector's words
    assert m2.tolist() == [[0, 0], [0xFFFFFFFF, 0], [0xFFFFFFFF, 1],
                           [0xFFFFFFFF, 0x7FFFFFFF]]
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678])
    assert popcount32(x).tolist() == [0, 1, 32, 1, 13]


def test_kernel_row_width_checks_layout_and_alignment():
    # what the CUDA wrappers check before a launch, on CPU tensors
    bwt = _bwt(4, 5000)
    widths = {lay: pfocc.kernel_row_width(build_focc_host(bwt, 4, "cpu", lay))
              for lay in TYPES}
    assert widths == {"sector": 32, "bitplane": 128, "bytes": 384}
    sec = build_focc_host(bwt, 4, "cpu", "sector")
    as_bp = FusedOccBP(sec.rows, sec.C, sec.n, sec.sigma)
    with pytest.raises(ValueError, match="do not match the bitplane"):
        pfocc.kernel_row_width(as_bp)
    short = FusedOccSector(sec.rows[:-1], sec.C, sec.n, sec.sigma)
    with pytest.raises(ValueError, match="do not match the sector"):
        pfocc.kernel_row_width(short)         # the row of i == n is missing
    odd = FusedOccSector(sec.rows.reshape(-1)[16:-16].view(-1, 32), sec.C,
                         sec.n - 64, sec.sigma)
    with pytest.raises(ValueError, match="32-byte aligned"):
        pfocc.kernel_row_width(odd)
    with pytest.raises(TypeError, match="contiguous uint8"):
        pfocc.kernel_row_width(FusedOccSector(sec.rows.long(), sec.C, sec.n,
                                              sec.sigma))
