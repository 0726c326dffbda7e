"""The cases of ``tests/test_focc_build.py``, the port's rank-row
builder against the reference's chunked and monolithic builders.

On the grid of alphabets, lengths and chunk sizes the port's
``build_focc_host`` in the reference's own layout (bit-plane rows for
sigma <= 8, byte rows above) gives rows 0..nb and C byte for byte the
reference's chunked rows, and its plain ``rank`` / ``access`` /
``lf_step`` the reference's monolithic ``*_batch_f`` answers (integers:
tolerance 0).  The port sizes its passes itself (``OCC_CHUNK``), so the
reference's ``chunk_rows`` only varies the reference's side.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.ops.focc import (access_batch_f, build_focc, lf_step_batch_f,
                                 rank_batch_f)
from bwtb3m_tpu.ops.focc_build import build_focc_host as jax_build_focc_host
from bwtb3m_tpu_torch.ops import focc as pfocc
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host


def _own_layout(sigma):
    return "bitplane" if sigma <= 8 else "bytes"


def _assert_same_rows(got, ref, n):
    nb = (n + 255) // 256
    np.testing.assert_array_equal(
        got.rows.numpy(), np.asarray(ref.rows).view(np.uint8)[:nb + 1])
    np.testing.assert_array_equal(got.C.numpy().astype(np.uint32),
                                  np.asarray(ref.C))


def _assert_same_queries(got, ref, n, sigma, rng):
    qs = rng.integers(0, n + 1, 512).astype(np.int64)
    cs = rng.integers(0, sigma, 512).astype(np.int64)
    np.testing.assert_array_equal(
        pfocc.rank(got, torch.from_numpy(cs), torch.from_numpy(qs)).numpy(),
        np.asarray(rank_batch_f(ref, jnp.asarray(cs, jnp.int32),
                                jnp.asarray(qs, jnp.uint32))))
    ps = rng.integers(0, n, 512).astype(np.int64)
    np.testing.assert_array_equal(
        pfocc.access(got, torch.from_numpy(ps)).numpy(),
        np.asarray(access_batch_f(ref, jnp.asarray(ps, jnp.uint32))))
    s_ref, r_ref = lf_step_batch_f(ref, jnp.asarray(ps, jnp.uint32))
    s_got, r_got = pfocc.lf_step(got, torch.from_numpy(ps))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(r_got.numpy(), np.asarray(r_ref))


@pytest.mark.parametrize("sigma,n,chunk", [
    (5, 300_000, 128),          # bit-plane, many chunks
    (5, 262_144, 256),          # exact block multiple boundary
    (5, 70_001, 0),             # auto chunking, ragged tail block
    (2, 4_000, 64),             # tiny alphabet
    (8, 130_000, 512),          # bit-plane at the sigma=8 edge
    (12, 120_000, 128),         # byte rows, nibble transfer
    (16, 50_000, 64),           # byte rows, edge of nibble packing
    (200, 90_000, 256),         # byte rows, raw byte transfer
    (256, 66_000, 128),         # full byte alphabet
])
def test_rows_match_reference_chunked_and_monolithic(sigma, n, chunk):
    rng = np.random.default_rng(sigma * 1000 + n)
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    got = build_focc_host(bwt, sigma, "cpu", _own_layout(sigma))
    _assert_same_rows(got, jax_build_focc_host(bwt, sigma, chunk_rows=chunk),
                      n)
    _assert_same_queries(got, build_focc(jnp.asarray(bwt.astype(np.int32)),
                                         sigma), n, sigma, rng)


def test_unpadded_shape():
    rng = np.random.default_rng(3)
    n, sigma = 10_000, 5
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    ref = jax_build_focc_host(bwt, sigma, pad_shape=False)
    got = build_focc_host(bwt, sigma, "cpu", "bitplane")
    assert got.rows.shape == (got.num_rows(n), got.rows.shape[1])
    _assert_same_rows(got, ref, n)
    _assert_same_queries(got, ref, n, sigma, rng)


def test_empty():
    got = build_focc_host(np.zeros(0, np.uint8), 5, "cpu")
    ref = jax_build_focc_host(np.zeros(0, np.uint8), 5)
    assert got.n == ref.n == 0
    assert int(got.C.max()) == int(np.asarray(ref.C).max()) == 0
