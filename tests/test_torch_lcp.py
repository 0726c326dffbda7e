"""PLCP and LCP of the port against the JAX package, case for case as
``tests/test_lcp.py``: small strings, every string of 5 symbols over 2,
random texts, the succinct round trip, the RMQ tree, the slab route
(random and periodic texts, 128 lanes), byte alphabets on the slab and
device routes, rank compaction of a sparse alphabet, slab striping with
and without a precomputed (sa, isa), and the self-test harness.  Each
case holds the port's (plcp, sa) to the reference's and to the host
Phi/Kasai oracle.  Exact equality of arrays and file bytes (the values
are integers); the port runs on the CPU, where its Kasai walk takes its
plain version."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.lcp import plcp as R
from bwtb3m_tpu.lcp.rmm import RMMTree as RefRMMTree
from bwtb3m_tpu.ops.doubling import suffix_array as ref_suffix_array
from bwtb3m_tpu_torch.lcp import plcp as P
from bwtb3m_tpu_torch.lcp.rmm import RMMTree
from oracle import all_strings, naive_circular_sa, random_string


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _oracle(text):
    return R.kasai_plcp(text, naive_circular_sa(text))


@pytest.mark.parametrize("s", ["abbab#", "banana", "mississippi", "aaaa",
                               "abababab"])
def test_plcp_small_strings(s):
    text = np.array([ord(c) for c in s], dtype=np.int32)
    got = P.compute_plcp(text, device="cpu")
    _same(got, R.compute_plcp(text))
    _same(got, (_oracle(text), naive_circular_sa(text)))


def test_plcp_exhaustive_tiny():
    for s in all_strings(5, 2):
        got = P.compute_plcp(s, 2, device="cpu")
        _same(got, R.compute_plcp(s, 2))
        np.testing.assert_array_equal(got[0], _oracle(s), err_msg=str(s))


@pytest.mark.parametrize("n,sigma", [(100, 2), (500, 4), (1000, 8),
                                     (2000, 256)])
def test_plcp_random(n, sigma):
    text = random_string(n, sigma, seed=n * 7 + sigma)
    got = P.compute_plcp(text, sigma, device="cpu")
    _same(got, R.compute_plcp(text, sigma))
    np.testing.assert_array_equal(got[0], _oracle(text))


def test_plcp_succinct_roundtrip(tmp_path):
    text = random_string(700, 4, seed=1)
    plcp, _ = P.compute_plcp(text, 4, device="cpu")
    bits = P.encode_plcp_bits(plcp)
    np.testing.assert_array_equal(bits, R.encode_plcp_bits(plcp))
    assert len(bits) <= 2 * len(text) + int(plcp[0]) + 1
    np.testing.assert_array_equal(P.decode_plcp_bits(bits, len(plcp)), plcp)
    port, ref = str(tmp_path / "p.lcpbit"), str(tmp_path / "r.lcpbit")
    P.write_plcp_file(port, plcp)
    R.write_plcp_file(ref, plcp)
    assert open(port, "rb").read() == open(ref, "rb").read()
    for dec in (P.PLCPBitDecoder(ref, n=len(text)),
                R.PLCPBitDecoder(port, n=len(text))):
        np.testing.assert_array_equal(dec.all(), plcp)
        np.testing.assert_array_equal(dec.get([0, 5, 699]), plcp[[0, 5, 699]])
    with pytest.raises(ValueError, match="length mismatch"):
        P.PLCPBitDecoder(ref, n=len(text) + 1)


def test_rmm_tree(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, size=233)
    t, ref = RMMTree(vals), RefRMMTree(vals)
    for l, r in [(0, 233), (0, 1), (100, 101), (7, 200), (50, 64)]:
        v, i = t.rmq(l, r)
        assert (v, i) == ref.rmq(l, r)
        assert v == vals[l:r].min() and i == l + int(np.argmin(vals[l:r]))
    port, refp = str(tmp_path / "p.rmm"), str(tmp_path / "r.rmm")
    t.write(port)
    ref.write(refp)
    assert open(port, "rb").read() == open(refp, "rb").read()
    assert RMMTree.read(refp).rmq(7, 200) == RefRMMTree.read(port).rmq(
        7, 200) == t.rmq(7, 200)
    with pytest.raises(ValueError, match="bad rmq range"):
        t.rmq(5, 5)


def test_lcpbit_selftest_harness():
    from bwtb3m_tpu_torch.lcp.selftest import testn, testnk, testrandomn
    testn([ord(c) for c in "abbab#"], device="cpu")
    testnk(4, 2, device="cpu")
    testrandomn(512, 8, seed=3, device="cpu")


@pytest.mark.parametrize("n,kind", [(5000, "random"), (3000, "periodic")])
def test_plcp_scaled_matches_reference(n, kind):
    rng = np.random.default_rng(13)
    if kind == "random":
        text = rng.integers(0, 4, n).astype(np.int32)
    else:
        seg = rng.integers(0, 4, 61)
        text = np.tile(seg, n // 61 + 1)[:n].astype(np.int32)
        text[rng.integers(0, n, 30)] = rng.integers(0, 4, 30)
    got = P.compute_plcp_scaled(text, 4, lanes=128, device="cpu")
    _same(got, R.compute_plcp_scaled(text, 4, lanes=128))
    np.testing.assert_array_equal(got[0], R.kasai_plcp(text, got[1]))


def test_plcp_byte_alphabet_scaled_and_device():
    rng = np.random.default_rng(41)
    n = 4096
    text = rng.integers(0, 4, n).astype(np.int32)
    text[: n // 4] = rng.integers(0, 256, n // 4)
    text[0] = 255
    sigma = 256
    plcp, sa = P.compute_plcp_scaled(text, sigma, lanes=128, device="cpu")
    ref = R.kasai_plcp(text, sa)
    np.testing.assert_array_equal(plcp, ref)
    _same((plcp, sa), R.compute_plcp_scaled(text, sigma, lanes=128))
    # slabs of 1024 positions
    plcp2, _ = P.compute_plcp_scaled(text, sigma, lanes=64,
                                     slab_positions=1024, device="cpu")
    np.testing.assert_array_equal(plcp2, ref)
    # the device route on the doubling's SA
    sa_d, _isa, _bwt = ref_suffix_array(text, sigma)
    plcp3 = P.compute_plcp_device(text, sigma, torch.from_numpy(
        np.asarray(sa_d, np.int64)), lanes=128, device="cpu")
    assert plcp3.dtype == torch.int32
    np.testing.assert_array_equal(plcp3.numpy().astype(np.int64), ref)


def test_plcp_wide_alphabet_rank_compaction():
    rng = np.random.default_rng(43)
    alpha = np.sort(rng.choice(1 << 20, size=100, replace=False))
    text = alpha[rng.integers(0, 100, 3000)].astype(np.int32)
    got = P.compute_plcp(text, 1 << 20, device="cpu")
    _same(got, R.compute_plcp(text, 1 << 20))
    np.testing.assert_array_equal(got[0], R.kasai_plcp(text, got[1]))


def test_plcp_scaled_slab_striping():
    rng = np.random.default_rng(31)
    n = 7001
    text = rng.integers(0, 4, n).astype(np.int32)
    plcp, sa = P.compute_plcp_scaled(text, 4, lanes=64, slab_positions=1024,
                                     device="cpu")
    ref = R.kasai_plcp(text, sa)
    np.testing.assert_array_equal(plcp, ref)
    _same((plcp, sa), R.compute_plcp_scaled(text, 4, lanes=64,
                                            slab_positions=1024))
    # a precomputed (sa, isa) skips the doubling sort
    isa = np.zeros(n, np.int64)
    isa[sa] = np.arange(n)
    plcp2, sa2 = P.compute_plcp_scaled(text, 4, lanes=64, sa_isa=(sa, isa),
                                       slab_positions=2048, device="cpu")
    np.testing.assert_array_equal(plcp2, ref)
    np.testing.assert_array_equal(sa2, sa)
