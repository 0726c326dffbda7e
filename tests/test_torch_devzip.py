"""The port's zip, zip plan, region bytes and k-bit packing against the
reference package's.

On the oracle corpora of ``tests/test_devzip.py`` (random compositions,
the int32 heavy-cell case with cells past 2^16, the count-right-before
case, and a total past one 2^24-symbol zip chunk of the reference, which
the port writes in many small chunks), ``device_interleave`` /
``zip_plan`` / ``cnt_le_at_ranks`` must equal the reference's and the
zip definition itself: for r = 0..B emit gap[r] left symbols, then
right[r].  Region bytes round-trip, rank rows built from them equal the
reference's ``build_focc_from_rows``, and ``pack_bits`` /
``unpack_bits`` equal ``pack_bits_device`` / ``unpack_bits_device``.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.ops import devzip as jz
from bwtb3m_tpu.ops.focc_build import build_focc_from_rows
from bwtb3m_tpu.ops.gapdev import _pad_pow2
from bwtb3m_tpu.ops.pack import pack_bits_device, unpack_bits_device
from bwtb3m_tpu_torch.ops import devzip as pz
from bwtb3m_tpu_torch.ops.focc_build import (build_focc_from_packed,
                                             build_focc_host)
from bwtb3m_tpu_torch.ops.pack import pack_bits, unpack_bits


def _oracle(gap, left, right):
    cnt_le = np.cumsum(gap.astype(np.int64))
    out = np.empty(len(left) + len(right), np.uint8)
    M = len(right)
    out[np.arange(M) + cnt_le[:M]] = right
    out[np.repeat(np.arange(M + 1), gap) + np.arange(len(left))] = left
    return out


def _random_case(rng, A, B, sigma):
    left = rng.integers(0, sigma, A).astype(np.uint8)
    right = rng.integers(0, sigma, B).astype(np.uint8)
    cuts = np.sort(rng.integers(0, A + 1, B))
    gap = np.diff(np.concatenate([[0], cuts, [A]])).astype(np.int64)
    return left, right, gap


def _gap_jax(gap, dtype=np.uint16):
    grows = _pad_pow2((len(gap) + 255) // 256, lo=4)
    g = np.zeros((grows, 256), dtype)
    g.reshape(-1)[:len(gap)] = gap.astype(dtype)
    return jnp.asarray(g)


def _zip_both(left, right, gap, sigma, dtype=np.uint16, chunk=pz.ZIP_CHUNK):
    A, B = len(left), len(right)
    bits = pz.bits_for(sigma)
    gd = _gap_jax(gap, dtype)
    want = jz.rows_to_host_bwt(jz.device_interleave(
        jz.rows_from_host_bwt(left, sigma), A,
        jz.rows_from_host_bwt(right, sigma), B, gd,
        jz.gap_row_cum_excl(gd), bits), A + B, bits)
    got = pz.rows_to_host_bwt(pz.device_interleave(
        pz.rows_from_host_bwt(left, sigma, "cpu"), A,
        pz.rows_from_host_bwt(right, sigma, "cpu"), B,
        torch.from_numpy(gap.astype(np.int32)), bits, chunk=chunk),
        A + B, bits)
    return got, want


@pytest.mark.parametrize("sigma", [4, 200])
@pytest.mark.parametrize("A,B", [(700, 900), (4096, 4096), (1, 5),
                                 (5000, 3), (300, 0)])
def test_interleave_matches_reference(sigma, A, B):
    rng = np.random.default_rng(A * 7 + B + sigma)
    left, right, gap = _random_case(rng, A, B, sigma)
    got, want = _zip_both(left, right, gap, sigma, chunk=1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(gap, left, right))


def test_interleave_int32_heavy_cells():
    rng = np.random.default_rng(3)
    A, B, sigma = 1 << 18, 300, 4
    left = rng.integers(0, sigma, A).astype(np.uint8)
    right = rng.integers(0, sigma, B).astype(np.uint8)
    gap = np.zeros(B + 1, np.int64)
    gap[7] = 1 << 17          # would wrap a uint16 cell twice
    gap[B] = A - (1 << 17)
    got, want = _zip_both(left, right, gap, sigma, np.int32, chunk=1 << 15)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(gap, left, right))


def test_interleave_past_one_reference_chunk():
    """A total above the reference's 2^24-symbol zip chunk (its
    multi-chunk path, where a clamped write once relocated output), cut
    by the port into 2^20-symbol chunks."""
    rng = np.random.default_rng(0)
    A, B = 9_000_000, (1 << 24) + 5000 - 9_000_000
    gap = rng.multinomial(A, np.ones(B + 1) / (B + 1)).astype(np.int64)
    left = rng.integers(0, 4, A, dtype=np.uint8)
    right = rng.integers(0, 4, B, dtype=np.uint8)
    got, want = _zip_both(left, right, gap, 4, chunk=1 << 20)
    assert int((got != want).sum()) == 0
    assert int((got != _oracle(gap, left, right)).sum()) == 0


def test_zip_plan_and_cnt_le_match_reference():
    rng = np.random.default_rng(11)
    A, B = 100000, 70000
    cuts = np.sort(rng.integers(0, A + 1, B))
    gap = np.diff(np.concatenate([[0], cuts, [A]])).astype(np.int64)
    gd = _gap_jax(gap)
    rc = jz.gap_row_cum_excl(gd)
    ts = rng.integers(0, A + B + 1, 50).astype(np.int64)
    ranks = rng.integers(0, B + 1, 37).astype(np.int64)
    total_j, rs_j, cnt_j = jz.zip_plan(gd, rc, B, ts, ranks)
    g = torch.from_numpy(gap.astype(np.int32))
    total_p, rs_p, cnt_p = pz.zip_plan(g, B, ts, ranks)
    assert total_p == total_j == A
    np.testing.assert_array_equal(rs_p, np.asarray(rs_j)[:len(ts)])
    np.testing.assert_array_equal(cnt_p, cnt_j)
    np.testing.assert_array_equal(pz.cnt_le_at_ranks(g, ranks),
                                  jz.cnt_le_at_ranks(gd, rc, ranks))
    np.testing.assert_array_equal(rs_p, jz.count_right_before(gd, rc, B, ts))


@pytest.mark.parametrize("sigma,n", [(4, 5001), (9, 3000), (16, 777),
                                     (200, 2560)])
def test_region_bytes_and_rank_rows_match_reference(sigma, n):
    rng = np.random.default_rng(sigma + n)
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    bits = pz.bits_for(sigma)
    packed = pz.rows_from_host_bwt(bwt, sigma, "cpu")
    jrows = jz.rows_from_host_bwt(bwt, sigma)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jrows).view(np.uint8).reshape(-1)[
            :len(packed)])
    np.testing.assert_array_equal(pz.rows_to_host_bwt(packed, n, bits), bwt)
    # the reference's own layout: byte for byte; the layout the engine
    # takes ("auto": sector rows for sigma <= 4): equal to the host build
    got = build_focc_from_packed(packed, n, sigma, bits,
                                 "bitplane" if sigma <= 8 else "bytes")
    want = build_focc_from_rows(jrows, n, sigma)
    nb = (n + 255) // 256
    np.testing.assert_array_equal(
        got.rows.numpy(), np.asarray(want.rows).view(np.uint8)[:nb + 1])
    np.testing.assert_array_equal(got.C.numpy(),
                                  np.asarray(want.C).astype(np.int64))
    auto = build_focc_from_packed(packed, n, sigma, bits)
    host = build_focc_host(bwt, sigma, "cpu")
    assert type(auto) is type(host)
    assert auto.LAYOUT == ("sector" if sigma <= 4 else got.LAYOUT)
    assert torch.equal(auto.rows, host.rows) and torch.equal(auto.C, host.C)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_matches_reference(bits):
    rng = np.random.default_rng(bits)
    n = 8 * 123
    syms = rng.integers(0, 1 << bits, n).astype(np.int32)
    want = np.asarray(pack_bits_device(jnp.asarray(syms), bits))
    got = pack_bits(torch.from_numpy(syms), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpack_bits(got, bits, n - 5)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(unpack_bits_device(jnp.asarray(want), bits,
                                                    n - 5)))
    np.testing.assert_array_equal(back.numpy(), syms[:n - 5])


@pytest.mark.parametrize("bits", [1, 2, 3, 5])
def test_pack_refuses_other_widths(bits):
    syms = torch.zeros(8 * 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="4 or 8"):
        pack_bits(syms, bits)
    with pytest.raises(ValueError, match="4 or 8"):
        unpack_bits(torch.zeros(16, dtype=torch.uint8), bits, 16)
