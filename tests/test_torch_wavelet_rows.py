"""The wavelet rank rows against the reference's ``OccTable``.

``bwtb3m_tpu_torch/ops/wavelet_rows.py`` ports ``bwtb3m_tpu/ops/rank.py``
for alphabets past 256 symbols in another layout (an 8-ary wavelet matrix
of 64-byte blocks of 96 digits); the functions must be the same.  For
seeded BWTs over 257 to 65,536 symbols, ``rank``, ``access``, ``lf_step``
and ``occ_totals`` equal the reference's ``rank_batch``,
``access_batch``, ``lf_step_batch`` and ``occ_total_counts`` on
``build_occ`` (not packed), at n = 1, at the block edges 95, 96, 97,
191, 192, 193 and longer, with every rank in [0, n] among the positions.
``digit_rank``, the in-sector count the kernels repeat, equals a naive
count.  ``BwtResult.load_wavelet`` densifies
a sparse alphabet with the same symbol map as the reference's
``load_occ``.  Exact equality: the queries are integer.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from bwtb3m_tpu.engine.result import BwtResult as JaxResult
from bwtb3m_tpu.ops.lf import lf_step_batch
from bwtb3m_tpu.ops.rank import (access_batch, build_occ, occ_total_counts,
                                 rank_batch)
from bwtb3m_tpu_torch.engine.result import BwtResult, clear_caches
from bwtb3m_tpu_torch.io import formats
from bwtb3m_tpu_torch.io.rl import rl_encode
from bwtb3m_tpu_torch.ops import wavelet_rows as wr

CASES = [(257, n) for n in (1, 223, 224, 225)] + [
    (300, 224), (300, 4097), (5000, 225), (5000, 20011), (257, 9000)]


def _bwt(sigma, n, seed):
    rng = np.random.default_rng(seed)
    bwt = rng.integers(0, sigma, n).astype(np.int32)
    bwt[:min(n, sigma) // 2] = sigma - 1      # the top symbol present
    return bwt


def _positions(n, rng, k=700):
    return np.concatenate([[0, n], rng.integers(0, n + 1, k)]).astype(
        np.int32)


@pytest.mark.parametrize("sigma,n", CASES)
def test_queries_equal_occtable(sigma, n):
    bwt = _bwt(sigma, n, sigma * 7 + n)
    occ = build_occ(bwt, sigma)
    wm = wr.build_wavelet_host(bwt, sigma, "cpu")
    assert wm.levels == ((sigma - 1).bit_length() + 2) // 3
    assert wm.nblk == n // wr.BLOCK_DIGITS + 1
    rng = np.random.default_rng(n)
    i = _positions(n, rng)
    c = rng.integers(0, sigma, len(i)).astype(np.int32)
    c[:4] = [0, sigma - 1, int(bwt[0]), int(bwt[-1])]
    want = np.asarray(rank_batch(occ, jnp.asarray(c), jnp.asarray(i)))
    got = wr.rank(wm, torch.from_numpy(c), torch.from_numpy(i).long())
    np.testing.assert_array_equal(got.numpy(), want)
    r = np.minimum(i, n - 1)                   # access / LF: r in [0, n)
    np.testing.assert_array_equal(
        wr.access(wm, torch.from_numpy(r).long()).numpy(),
        np.asarray(access_batch(occ, jnp.asarray(r))))
    sym_j, r_j = lf_step_batch(occ, jnp.asarray(r))
    sym_t, r_t = wr.lf_step(wm, torch.from_numpy(r).long())
    np.testing.assert_array_equal(sym_t.numpy(), np.asarray(sym_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(wr.occ_totals(wm).numpy(),
                                  np.asarray(occ_total_counts(occ)))


EDGE_CASES = [(sigma, n) for sigma in (257, 300, 4096, 5000, 65536)
              for n in (1, 95, 96, 97, 191, 192, 193, 4099)]


@pytest.mark.parametrize("sigma,n", EDGE_CASES)
def test_rows_equal_occtable_at_sector_edges(sigma, n):
    """Every rank r in [0, n] of a symbol (BWT[r], BWT[r - 1] and random
    ones), every access and LF step, and the totals, against the
    reference's OccTable: 257 (3 levels), 4,096 (exactly 8^4, every digit
    of every level in use), 5,000 (5) and 65,536 (6 levels)."""
    bwt = _bwt(sigma, n, sigma + 3 * n)
    occ = build_occ(bwt, sigma)
    wm = wr.build_wavelet_host(bwt, sigma, "cpu")
    assert wm.levels == wr.levels_for(sigma) and wm.nblk == n // 96 + 1
    rng = np.random.default_rng(sigma * n)
    i = np.tile(np.arange(n + 1, dtype=np.int32), 3)
    c = np.concatenate([bwt[np.minimum(np.arange(n + 1), n - 1)],
                        bwt[np.maximum(np.arange(n + 1) - 1, 0)],
                        rng.integers(0, sigma, n + 1)]).astype(np.int32)
    np.testing.assert_array_equal(
        wr.rank(wm, torch.from_numpy(c), torch.from_numpy(i).long()).numpy(),
        np.asarray(rank_batch(occ, jnp.asarray(c), jnp.asarray(i))))
    r = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(
        wr.access(wm, torch.from_numpy(r).long()).numpy(), bwt)
    sym_j, r_j = lf_step_batch(occ, jnp.asarray(r))
    sym_t, r_t = wr.lf_step(wm, torch.from_numpy(r).long())
    np.testing.assert_array_equal(sym_t.numpy(), np.asarray(sym_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(wr.occ_totals(wm).numpy(),
                                  np.asarray(occ_total_counts(occ)))


def test_digit_rank_counts_digits():
    """digit_rank on seeded random plane words against a naive count, for
    every digit and every prefix of 0 to 32 digits."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, (256, 3), dtype=np.uint64)
    words[:4] = [[0, 0, 0], [0xFFFFFFFF] * 3, [0x55555555, 0, 0xFFFFFFFF],
                 [0xAAAAAAAA, 0xFFFFFFFF, 0]]
    bit = (words[:, None, :] >> np.arange(32, dtype=np.uint64)[None, :,
                                                                None]) & 1
    digits = (bit[:, :, 0] | bit[:, :, 1] << 1 | bit[:, :, 2] << 2)
    w = torch.from_numpy(words.astype(np.int64))[:, None, None, :]
    d = torch.arange(8)[None, :, None]
    keep = torch.arange(33)[None, None, :]
    got = wr.digit_rank(w, d, keep).numpy()
    want = np.zeros((len(words), 8, 33), np.int64)
    for k in range(1, 33):
        want[:, :, k] = want[:, :, k - 1] + (
            digits[:, k - 1, None] == np.arange(8)[None, :])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [257, 5000])
def test_every_rank_of_every_symbol_at_sector_edges(sigma):
    """rank(c, i) for every symbol c at the positions around each sector
    edge (95, 96, 97, 191, ...) and at n: the count words, the last plane
    words and the pad block."""
    n = 3 * wr.BLOCK_DIGITS
    bwt = _bwt(sigma, n, sigma)
    occ = build_occ(bwt, sigma)
    wm = wr.build_wavelet_host(bwt, sigma, "cpu")
    edges = [e + d for e in (96, 192, 288) for d in (-1, 0, 1) if e + d <= n]
    i = np.repeat(np.array(edges + [0, 1], np.int32), sigma)
    c = np.tile(np.arange(sigma, dtype=np.int32), len(edges) + 2)
    want = np.asarray(rank_batch(occ, jnp.asarray(c), jnp.asarray(i)))
    got = wr.rank(wm, torch.from_numpy(c), torch.from_numpy(i).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_wavelet_from_jax_holds_the_table_bwt():
    bwt = _bwt(300, 5000, 3)
    occ = build_occ(bwt, 300)
    wm = wr.wavelet_from_jax(occ)
    r = torch.arange(5000)
    np.testing.assert_array_equal(wr.access(wm, r).numpy(), bwt)


def test_memory_against_occtable():
    """The rows' bytes against the reference layout's at the chip path's
    shape (400,000,009 symbols over 5,000 symbols): 5 levels of 64-byte
    blocks of 96 digits, 48.1x smaller than the OccTable."""
    n, sigma = 400_000_009, 5000
    blocks = wr.levels_for(sigma) * (n // wr.BLOCK_DIGITS + 1) * 64
    assert blocks == 5 * 4_166_667 * 64
    assert wr.occtable_bytes(n, sigma) > 45 * blocks


@pytest.mark.parametrize("sparse", [True, False])
def test_load_wavelet_densifies_like_load_occ(tmp_path, sparse):
    """A .bwt over a sparse alphabet (code points) or a dense one: the
    port's rows answer the reference's dense OccTable's queries, with
    the same symbol map."""
    rng = np.random.default_rng(11)
    sigma_file = 0x4e00 + 5000 if sparse else 3000
    alphabet = (np.sort(rng.choice(np.arange(0x4e00, 0x4e00 + 5000), 1200,
                                   replace=False)) if sparse
                else np.arange(3000))
    n = 9001
    bwt = alphabet[rng.integers(0, len(alphabet), n)].astype(np.int32)
    bwt[:len(alphabet)] = alphabet
    base = str(tmp_path / "x")
    rl_encode(base + ".bwt", bwt, sigma=sigma_file)
    formats.write_meta(base + ".meta", {
        "format": "bwtb3m_tpu/v1", "n": n, "sigma": sigma_file,
        "files": {"bwt": base + ".bwt"}})
    occ, jmap = JaxResult.load(base + ".bwt").load_occ(dense=True)
    clear_caches()
    wm, tmap = BwtResult.load(base + ".bwt").load_wavelet("cpu")
    if sparse:
        np.testing.assert_array_equal(tmap, np.asarray(jmap))
    else:
        assert tmap is None and jmap is None
    assert wm.sigma == int(occ.sigma)
    i = _positions(n, rng)
    c = rng.integers(0, wm.sigma, len(i)).astype(np.int32)
    np.testing.assert_array_equal(
        wr.rank(wm, torch.from_numpy(c), torch.from_numpy(i).long()).numpy(),
        np.asarray(rank_batch(occ, jnp.asarray(c), jnp.asarray(i))))


def test_build_gates():
    with pytest.raises(ValueError, match="2097152"):
        wr.build_wavelet(torch.zeros(4, dtype=torch.int32), (1 << 21) + 1)
    with pytest.raises(ValueError, match="outside"):
        wr.build_wavelet(torch.tensor([0, 300], dtype=torch.int32), 300)
    assert wr.levels_for(257) == 3 and wr.levels_for(65536) == 6
    assert wr.levels_for(5000) == 5 and wr.levels_for(4096) == 4
    assert wr.levels_for(150_000) == 6 and wr.levels_for(1 << 21) == 7
    assert wr.smem_bytes(5000) == 20000 and wr.smem_bytes(13000) == 0
    # the static digit table of 7 levels shares the 48 KB: 12,232 symbols
    # at most
    assert wr.smem_bytes(12232) == 48928 and wr.smem_bytes(12233) == 0
