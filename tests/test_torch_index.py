"""The port's index package against the reference's, on the same inputs.

The cases of tests/test_index.py, tests/test_bidir.py and
tests/test_cst.py run on both packages from the same numpy inputs (made
from a seed): bitvector ranks and bytes, Huffman codes, the HWT, RLHWT
and DNR1 bytes and queries, the FM index's ranks, intervals,
``locate_batch``, ``extract`` (the wrap included) and ``extended_lf``,
BWA export bytes, the bidirectional index's synchronized intervals, and
the compressed suffix tree's navigation.  Then the locate and decode
walks (the LF-walk kernel's locate and decode visits; their plain
versions here) over every row family: sector, bit-plane and byte rows,
wide rows doctored so that every occ count crosses 2^32, and wavelet
rows past 256 symbols, against the reference ``FMIndex`` over the same
BWT; ``backward_search_step`` over each family against the reference's
``step``; and ``hamming_search``'s list against the reference's
recursion, order included, by the breadth-first search and by its plain
version (``ops/lf.py::hamming_search_plain``, the recursion itself).  Every comparison is exact.  The wrappers take the
plain versions for CPU tensors, so no launch is counted here.
"""

import io as _io

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.index import bitvector as jbv
from bwtb3m_tpu.index.bidir import BidirectionalFMIndex as JaxBidir
from bwtb3m_tpu.index.bwa import rewrite as jax_rewrite
from bwtb3m_tpu.index.cst import CompressedSuffixTree as JaxCst
from bwtb3m_tpu.index.dnarank import DNARank as JaxDNARank
from bwtb3m_tpu.index.fm import FMIndex as JaxFM
from bwtb3m_tpu.index.huffman import HuffmanTree as JaxTree
from bwtb3m_tpu.index.sampled import SampledISA as JaxSISA
from bwtb3m_tpu.index.sampled import SampledSA as JaxSSA
from bwtb3m_tpu.index import wavelet as jwt
from bwtb3m_tpu.apps.hamdna import hamming_search as jax_hamming
from bwtb3m_tpu_torch.apps.hamdna import hamming_search, hamming_search_batch
from bwtb3m_tpu_torch.engine.result import BwtResult
from bwtb3m_tpu_torch.index import bitvector as pbv
from bwtb3m_tpu_torch.index import wavelet as pwt
from bwtb3m_tpu_torch.index.bidir import BidirectionalFMIndex, bidir_from_jax
from bwtb3m_tpu_torch.index.bwa import rewrite
from bwtb3m_tpu_torch.index.cst import CompressedSuffixTree
from bwtb3m_tpu_torch.index.dnarank import DNARank
from bwtb3m_tpu_torch.index.fm import FMIndex, decode_lanes, fm_from_jax
from bwtb3m_tpu_torch.index.huffman import HuffmanTree
from bwtb3m_tpu_torch.index.sampled import SampledISA, SampledSA
from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops import wideocc as pw
from bwtb3m_tpu_torch.ops.focc_bp import rank_all_batch_bp
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from bwtb3m_tpu_torch.ops.lf import (backward_search_step, c_values,
                                     hamming_search_plain)
from bwtb3m_tpu_torch.ops.wavelet_rows import build_wavelet_host
from oracle import naive_bwt, naive_circular_sa, random_string


def _bytes(obj, path_or_buf=None):
    buf = _io.BytesIO()
    obj.write(buf)
    return buf.getvalue()


# ------------------------------------------------------------ host structures

@pytest.mark.parametrize("kind", ["RankBitVector", "RLBitVector"])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 512, 513, 3000])
def test_bitvector_rank(kind, n):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < 0.3).astype(np.uint8)
    a, b = getattr(pbv, kind)(bits), getattr(jbv, kind)(bits)
    qs = np.arange(n + 1)
    np.testing.assert_array_equal(a.rank1(qs), b.rank1(qs))
    np.testing.assert_array_equal(a.rank0(qs), b.rank0(qs))
    np.testing.assert_array_equal(a.rank1(qs), np.r_[0, np.cumsum(bits)])
    if n:
        np.testing.assert_array_equal(a.get(np.arange(n)), bits)
    assert a.total_ones == b.total_ones
    assert _bytes(a) == _bytes(b)
    back = getattr(pbv, kind).read(_io.BytesIO(_bytes(b)))
    np.testing.assert_array_equal(back.rank1(qs), b.rank1(qs))


def test_huffman_prefix_free_and_deterministic():
    hist = {0: 5, 1: 5, 2: 3, 7: 100, 9: 1}
    t, ref = HuffmanTree(hist), JaxTree(dict(hist))
    assert t.code == ref.code and t.length == ref.length
    assert t.children == ref.children
    assert t.encode_lengths() == ref.encode_lengths()
    assert all(t.decode_path(s) == ref.decode_path(s) for s in hist)
    t3 = HuffmanTree.from_lengths(t.encode_lengths())
    assert t3.code == t.code


def test_huffman_single_symbol():
    t = HuffmanTree({42: 10})
    assert t.length[42] == 1 and t.num_inner == 1
    assert t.code == JaxTree({42: 10}).code


def _skew(sigma):
    p = 1.0 / (np.arange(sigma) + 1.0)
    return p / p.sum()


@pytest.mark.parametrize("kind", ["HuffmanWaveletTree",
                                  "RLHuffmanWaveletTree"])
@pytest.mark.parametrize("sigma", [2, 5, 17, 200])
def test_wavelet_queries(tmp_path, kind, sigma):
    rng = np.random.default_rng(sigma)
    syms = rng.choice(sigma, p=_skew(sigma), size=2000).astype(np.int64)
    wt, ref = getattr(pwt, kind).build(syms), getattr(jwt, kind).build(syms)
    np.testing.assert_array_equal(wt.decode_all(), syms)
    qs = np.array([0, 1, 7, 100, 999, 2000])
    for c in [0, sigma // 2, sigma - 1, sigma + 3]:
        np.testing.assert_array_equal(wt.rank(c, qs), ref.rank(c, qs))
    s, r = wt.inverse_select(np.arange(len(syms)))
    s2, r2 = ref.inverse_select(np.arange(len(syms)))
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(wt.C, ref.C)
    path, path_ref = str(tmp_path / "w"), str(tmp_path / "w.ref")
    wt.write(path)
    ref.write(path_ref)
    assert open(path, "rb").read() == open(path_ref, "rb").read()
    back = getattr(pwt, kind).read(path_ref)
    np.testing.assert_array_equal(back.decode_all(), syms)
    with pytest.raises(ValueError, match="bad wavelet magic"):
        (pwt.RLHuffmanWaveletTree if kind == "HuffmanWaveletTree"
         else pwt.HuffmanWaveletTree).read(path)


def test_wavelet_sparse_large_symbols(tmp_path):
    rng = np.random.default_rng(31)
    alphabet = np.array([97, 233, 956, 8364, 28450], dtype=np.int64)
    syms = alphabet[rng.integers(0, len(alphabet), 1500)]
    wt = pwt.HuffmanWaveletTree.build(syms)
    ref = jwt.HuffmanWaveletTree.build(syms)
    np.testing.assert_array_equal(wt.decode_all(), syms)
    for c in alphabet:
        qs = np.array([0, 100, 1500])
        np.testing.assert_array_equal(wt.rank(int(c), qs), ref.rank(int(c),
                                                                    qs))
    wt.write(str(tmp_path / "u.hwt"))
    ref.write(str(tmp_path / "r.hwt"))
    assert (open(str(tmp_path / "u.hwt"), "rb").read()
            == open(str(tmp_path / "r.hwt"), "rb").read())


@pytest.mark.parametrize("block", [64, 256])
def test_dnarank(tmp_path, block):
    rng = np.random.default_rng(block)
    syms = rng.integers(0, 4, size=5000, dtype=np.uint8)
    dr, ref = DNARank(syms, block=block), JaxDNARank(syms, block=block)
    qs = np.array([0, 1, 63, 64, 65, 255, 256, 257, 2500, 5000])
    for c in range(4):
        np.testing.assert_array_equal(dr.rank(c, qs), ref.rank(c, qs))
    np.testing.assert_array_equal(dr.symbol(np.arange(5000)), syms)
    dr.write(str(tmp_path / "p.dnarank"))
    ref.write(str(tmp_path / "r.dnarank"))
    assert (open(str(tmp_path / "p.dnarank"), "rb").read()
            == open(str(tmp_path / "r.dnarank"), "rb").read())
    back = DNARank.read(str(tmp_path / "r.dnarank"))
    for c in range(4):
        np.testing.assert_array_equal(back.rank(c, qs), ref.rank(c, qs))
    with pytest.raises(ValueError, match="4-symbol"):
        DNARank(np.array([0, 4], np.uint8))


def test_sampled_sa_subsample(tmp_path):
    vals = np.arange(0, 100, 4)
    s2 = SampledSA(4, vals, 100).subsample(4)
    assert s2.rate == JaxSSA(4, vals, 100).subsample(4).rate == 16
    np.testing.assert_array_equal(s2.values, vals[::4])
    with pytest.raises(ValueError):
        SampledSA(4, vals, 100).subsample(3)
    isa = SampledISA(8, np.arange(13), 100)
    np.testing.assert_array_equal(isa.get([0, 16]), [0, 2])
    with pytest.raises(ValueError):
        isa.get([3])
    path = str(tmp_path / "x.sa")
    s2.save(path)
    assert SampledSA.load(path, 100).rate == JaxSSA.load(path, 100).rate


# ------------------------------------------------------------ FM index

def _jax_build(tmp_path, data: bytes, name="t", **kw):
    inp = tmp_path / (name + ".bin")
    inp.write_bytes(data)
    kw.setdefault("preisa_sampling_rate", 128)
    kw.setdefault("sa_sampling_rate", 8)
    kw.setdefault("isa_sampling_rate", 8)
    res = jax_compute_bwt(JaxOptions(input_path=str(inp), verbose=0, **kw))
    return res, BwtResult.load(res.bwt_path)


@pytest.mark.parametrize("structure", ["hwt", "rlhwt", "dnarank"])
def test_fm_index_search_locate_extract(tmp_path, structure):
    text = random_string(800, 4, seed=3)
    if structure != "dnarank":
        text = text + 97                     # bytes a..d
    res, pres = _jax_build(tmp_path, bytes(text.astype(np.uint8)))
    ref = JaxFM.from_bwt_result(res, structure=structure)
    fm = FMIndex.from_bwt_result(pres, structure=structure, device="cpu")
    np.testing.assert_array_equal(fm.C, ref.C)
    rng = np.random.default_rng(0)
    for plen in [1, 2, 3, 5, 9]:
        for _ in range(5):
            start = int(rng.integers(0, len(text) - plen))
            pat = text[start:start + plen]
            assert fm.backward_search(pat) == ref.backward_search(pat)
            assert fm.count(pat) == ref.count(pat)
            lo, hi = ref.backward_search(pat)
            np.testing.assert_array_equal(fm.locate_range(lo, hi),
                                          ref.locate_range(lo, hi))
            np.testing.assert_array_equal(
                fm.locate_range(lo, hi),
                np.sort(naive_circular_sa(text)[lo:hi]))
    absent = [] if structure == "dnarank" else [0, 250]   # DNARank: 0..3
    if absent:
        assert fm.backward_search([120, 97]) == ref.backward_search([120,
                                                                     97])
    ranks = np.arange(len(text))
    np.testing.assert_array_equal(fm.locate_batch(ranks),
                                  ref.locate_batch(ranks))
    assert fm.locate(17) == ref.locate(17)
    assert fm.last_locate["lanes"] == 1
    for start, length in [(0, 10), (100, 33), (795, 10), (0, 800),
                          (5, 800), (799, 1), (3, 797), (7, 1000)]:
        np.testing.assert_array_equal(fm.extract(start, length),
                                      ref.extract(start, length))
    for c in sorted(set(text.tolist())) + absent:
        np.testing.assert_array_equal(fm.rank(c, np.arange(801)),
                                      ref.rank(c, np.arange(801)))
        np.testing.assert_array_equal(fm.step(c, 10, 700),
                                      ref.step(c, 10, 700))
    for a, b in zip(fm.extended_lf(ranks), ref.extended_lf(ranks)):
        np.testing.assert_array_equal(a, b)
    carried = fm_from_jax(ref, "cpu")
    np.testing.assert_array_equal(carried.locate_batch(ranks),
                                  ref.locate_batch(ranks))
    np.testing.assert_array_equal(carried.extract(790, 20),
                                  ref.extract(790, 20))


def test_fm_structure_refusals_and_missing_samples(tmp_path):
    res, pres = _jax_build(tmp_path, b"hello world, hello index " * 9,
                           sa_sampling_rate=4, isa_sampling_rate=4)
    with pytest.raises(ValueError, match="4-symbol"):
        JaxFM.from_bwt_result(res, structure="dnarank")
    with pytest.raises(ValueError, match="4-symbol"):
        FMIndex.from_bwt_result(pres, structure="dnarank", device="cpu")
    ref = JaxFM.from_bwt_result(res)
    fm = FMIndex(None, ref.sigma, ref.n, device="cpu",
                 rows=FMIndex.from_bwt_result(pres, device="cpu").rows)
    with pytest.raises(ValueError, match="no sampled SA"):
        fm.locate_batch([1])
    with pytest.raises(ValueError, match="no sampled ISA"):
        fm.extract(0, 3)


@pytest.mark.parametrize("kind", ["hwt", "rlhwt", "dnarank"])
def test_fm_index_from_a_ranker(kind):
    """A directly constructed index builds its rows from the ranker's
    symbols; its C and answers are the reference's over the same
    ranker."""
    text = random_string(600, 4, seed=9)
    sa = naive_circular_sa(text)
    bwt = text[(sa - 1) % len(text)]
    isa = np.empty(len(text), np.int64)
    isa[sa] = np.arange(len(text))
    if kind == "dnarank":
        mine, theirs = DNARank(bwt.astype(np.uint8)), JaxDNARank(
            bwt.astype(np.uint8))
    else:
        name = {"hwt": "HuffmanWaveletTree",
                "rlhwt": "RLHuffmanWaveletTree"}[kind]
        mine = getattr(pwt, name).build(bwt)
        theirs = getattr(jwt, name).build(bwt)
    fm = FMIndex(mine, 4, len(text), SampledSA(8, sa[::8], len(text)),
                 SampledISA(16, isa[::16], len(text)), device="cpu")
    ref = JaxFM(theirs, 4, len(text), JaxSSA(8, sa[::8], len(text)),
                JaxSISA(16, isa[::16], len(text)))
    np.testing.assert_array_equal(fm.C, ref.C)
    pat = text[17:23]
    assert fm.backward_search(pat) == ref.backward_search(pat)
    np.testing.assert_array_equal(fm.locate_batch(np.arange(600)),
                                  ref.locate_batch(np.arange(600)))
    np.testing.assert_array_equal(fm.extract(590, 25), ref.extract(590, 25))


def test_bwa_export(tmp_path):
    from bwtb3m_tpu_torch.index.bwa import read_bwa_bwt, read_bwa_sa
    from bwtb3m_tpu_torch.io.pac import write_pac
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=777, dtype=np.int32)
    pacp = str(tmp_path / "g.pac")
    write_pac(pacp, codes)
    res = jax_compute_bwt(JaxOptions(input_path=pacp, input_type="pacterm",
                                     sa_sampling_rate=32,
                                     isa_sampling_rate=32,
                                     preisa_sampling_rate=128, verbose=0))
    outs = [str(tmp_path / x) for x in ("p.bwt", "p.sa", "r.bwt", "r.sa")]
    rewrite(res.bwt_path, outs[0], outs[1], verbose=0)
    jax_rewrite(res.bwt_path, outs[2], outs[3], verbose=0)
    for a, b in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert open(a, "rb").read() == open(b, "rb").read()
    primary, L2, bases = read_bwa_bwt(outs[0])
    text = np.concatenate([codes + 1, [0]]).astype(np.int32)
    full_bwt = naive_bwt(text)
    assert primary == int(np.flatnonzero(full_bwt == 0)[0])
    np.testing.assert_array_equal(bases, np.delete(full_bwt, primary) - 1)
    p2, _L2, sa_intv, seq_len, vals = read_bwa_sa(outs[1])
    assert p2 == primary and seq_len == len(codes) and sa_intv == 32
    np.testing.assert_array_equal(vals, naive_circular_sa(text)[::32][1:])


def test_fm_backward_search_wide_alphabet(tmp_path):
    """UTF-8 past 256 symbols: the wavelet rows."""
    text = ("αβγδ εζηθ ικλμ " * 40) + "νξοπ"
    p = tmp_path / "g.txt"
    p.write_text(text, encoding="utf-8")
    res = jax_compute_bwt(JaxOptions(input_path=str(p), input_type="utf-8",
                                     sa_sampling_rate=8, isa_sampling_rate=8,
                                     preisa_sampling_rate=64, verbose=0))
    ref = JaxFM.from_bwt_result(res, structure="hwt")
    fm = FMIndex.from_bwt_result(BwtResult.load(res.bwt_path), device="cpu")
    assert type(fm.rows).__name__ == "WaveletRows"
    codes = np.array([ord(c) for c in text], dtype=np.int64)
    for a in (5, 40, 100):
        pat = codes[a:a + 7]
        assert fm.backward_search(pat) == ref.backward_search(pat)
        lo, hi = ref.backward_search(pat)
        np.testing.assert_array_equal(fm.locate_batch(np.arange(lo, hi)),
                                      ref.locate_batch(np.arange(lo, hi)))
    np.testing.assert_array_equal(fm.extract(len(codes) - 3, 9),
                                  ref.extract(len(codes) - 3, 9))
    np.testing.assert_array_equal(fm.extract(len(codes) - 3, 9),
                                  np.take(codes, np.arange(-3, 6)))


# ------------------------------------------------ the walks on every family

def _rows(family, bwt, sigma):
    if family == "wavelet":
        return build_wavelet_host(bwt, sigma, "cpu")
    if family == "wide":
        cnt = np.bincount(bwt, minlength=sigma)
        base = torch.from_numpy(((1 << 32) - cnt // 2).astype(np.int64))
        w = pw.doctored(torch.from_numpy(bwt.astype(np.uint8)), sigma,
                        "sector", base)
        assert int((w.thr != pw.THR_PAD).sum()) == int((cnt > 0).sum())
        return w
    return build_focc_host(bwt.astype(np.uint8), sigma, "cpu", family)


# (family, sigma): the byte rows at 20 symbols (any sigma <= 256 takes
# the same rows), the wavelet rows just past 256 (three levels)
FAMILIES = [("sector", 4), ("bitplane", 4), ("bitplane", 7),
            ("bytes", 20), ("wide", 4), ("wavelet", 260)]


def _index_case(family, sigma, sarate, isarate, with_sa=True):
    """(text, sa, isa, reference FMIndex over a wavelet tree, the port's
    FMIndex over ``family`` rows, the generator that drew the text) of
    one seeded text of 333 + sigma symbols, the sampled SA left out of
    both where not ``with_sa``."""
    n = 333 + sigma
    rng = np.random.default_rng(sigma + sarate)
    text = rng.integers(0, sigma, n)
    text[:sigma] = np.arange(sigma)
    sa = naive_circular_sa(text)
    bwt = text[(sa - 1) % n]
    isa = np.empty(n, np.int64)
    isa[sa] = np.arange(n)
    ref = JaxFM(jwt.HuffmanWaveletTree.build(bwt), sigma, n,
                JaxSSA(sarate, sa[::sarate], n) if with_sa else None,
                JaxSISA(isarate, isa[::isarate], n))
    fm = FMIndex(None, sigma, n,
                 SampledSA(sarate, sa[::sarate], n) if with_sa else None,
                 SampledISA(isarate, isa[::isarate], n), device="cpu",
                 rows=_rows(family, bwt, sigma))
    return text, sa, isa, ref, fm, rng


@pytest.mark.parametrize("family,sigma", FAMILIES)
@pytest.mark.parametrize("sarate,isarate", [(8, 16), (5, 300)])
def test_locate_and_decode_walks_match_the_reference(family, sigma, sarate,
                                                     isarate):
    """The locate and decode walks (plain versions) over each row family
    give the reference FMIndex's ``locate_batch`` and ``extract`` over a
    wavelet tree of the same BWT, at power-of-two and other rates (an
    ISA rate past n / 2: one range's lanes wrap past n)."""
    text, sa, isa, ref, fm, rng = _index_case(family, sigma, sarate,
                                              isarate)
    n = len(text)
    ranks = rng.integers(0, n, 150)
    np.testing.assert_array_equal(fm.locate_batch(ranks),
                                  ref.locate_batch(ranks))
    np.testing.assert_array_equal(fm.locate_batch(ranks), sa[ranks])
    r_end, steps = lw.locate_walk_plain(fm.rows, torch.from_numpy(ranks),
                                        sarate)
    assert bool((r_end % sarate == 0).all())
    assert int(steps.max()) == fm.last_locate["longest"]
    for start, length in [(0, 100), (n - 40, 90), (123, n), (17, 1)]:
        np.testing.assert_array_equal(fm.extract(start, length),
                                      ref.extract(start, length))
    assert lw.lf_walk.launches == 0


@pytest.mark.parametrize("family,sigma", FAMILIES)
@pytest.mark.parametrize("sarate,isarate", [(8, 16), (5, 300)])
@pytest.mark.parametrize("with_sa", [True, False])
def test_extract_from_sa_sample_lanes(family, sigma, sarate, isarate,
                                      with_sa):
    """``FMIndex.extract`` over each row family through its lane plan,
    ``decode_lanes_sa`` where the index holds a sampled SA and
    ``decode_lanes`` where it holds none, gives the reference's
    ``extract`` and the text, on ranges across the end of the text and of
    n symbols.  The SA-sample plan: positions strictly increasing in
    unwrapped coordinates and the rank of each position, segments
    that sum to A - start (A the last lane of ``decode_lanes``), every
    lane of ``decode_lanes`` present, the SA samples in (start, A] added,
    and no segment longer than the longest of ``decode_lanes``."""
    text, sa, _isa, ref, fm, _rng = _index_case(family, sigma, sarate,
                                                isarate, with_sa)
    n = len(text)
    rank_of = np.empty(n, np.int64)
    rank_of[sa] = np.arange(n)
    for start, length in [(0, 100), (n - 40, 90), (123, n), (17, 1),
                          (n - 1, n)]:
        got = fm.extract(start, length)
        np.testing.assert_array_equal(got, ref.extract(start, length))
        np.testing.assert_array_equal(
            got, np.take(text, (start + np.arange(length)) % n))
        r, p, seg = (t.numpy() for t in fm.decode_plan(start, length))
        r_i, p_i, seg_i = decode_lanes(fm.isa, n, start, length)
        if not with_sa:
            for a, b in ((r, r_i), (p, p_i), (seg, seg_i)):
                np.testing.assert_array_equal(a, b)
            continue
        x, x_i = start + np.cumsum(seg), start + np.cumsum(seg_i)
        assert (seg > 0).all() and x[-1] == x_i[-1]
        np.testing.assert_array_equal(p, x % n)
        np.testing.assert_array_equal(r, rank_of[p])
        assert np.isin(x_i, x).all()
        # every SA sample's unwrapped positions in (start, A]
        u = sa[::sarate][:, None] + np.array([0, n, 2 * n])[None, :]
        u = np.unique(u[(u > start) & (u <= x[-1])])
        np.testing.assert_array_equal(np.setdiff1d(x, x_i),
                                      np.setdiff1d(u, x_i))
        assert seg.max() <= seg_i.max()
    assert lw.lf_walk.launches == 0


def test_locate_walk_reports_a_lane_that_meets_no_sample():
    """The BWT of the periodic text 0101 is 1100: its LF has two cycles,
    0 -> 2 -> 0 and 1 -> 3 -> 1, and at rate 2 a lane on the second meets
    no sampled rank; it ends after n steps with -1 (the reference's
    ``locate_batch`` walks forever), and ``locate_batch`` raises."""
    focc = build_focc_host(np.array([1, 1, 0, 0], np.uint8), 2, "cpu")
    r, steps = lw.locate_walk(focc, torch.tensor([1, 3, 2, 0]), 2)
    assert steps.tolist() == [-1, -1, 0, 0]
    assert r.tolist()[2:] == [2, 0]
    fm = FMIndex(None, 2, 4, SampledSA(2, np.array([0, 2]), 4),
                 device="cpu", rows=focc)
    with pytest.raises(AssertionError, match="no sampled rank"):
        fm.locate_batch([1])


@pytest.mark.parametrize("family,sigma", FAMILIES)
def test_backward_search_step_matches_reference_step(family, sigma):
    n = 500 + sigma
    rng = np.random.default_rng(7 * sigma)
    bwt = rng.integers(0, sigma, n)
    bwt[:sigma] = np.arange(sigma)
    rows = _rows(family, bwt, sigma)
    ref = JaxFM(jwt.HuffmanWaveletTree.build(bwt), sigma, n)
    lo = rng.integers(0, n + 1, 400)
    hi = rng.integers(0, n + 1, 400)
    c = rng.integers(0, sigma, 400)
    l2, h2 = backward_search_step(rows, torch.from_numpy(c),
                                  torch.from_numpy(lo), torch.from_numpy(hi))
    for j in range(0, 400, 7):
        want = ref.step(int(c[j]), lo[j], hi[j])
        assert (int(l2[j]), int(h2[j])) == (int(want[0][0]),
                                            int(want[1][0]))
    if family != "wide":       # the doctored rows lower C by their base
        np.testing.assert_array_equal(c_values(rows).numpy(), ref.C)


# ------------------------------------------------------------ bidirectional

def _interval_oracle(text, w):
    n = len(text)
    sa = naive_circular_sa(np.asarray(text, np.int64))
    hits = [r for r in range(n)
            if all(text[(sa[r] + i) % n] == w[i] for i in range(len(w)))]
    return (hits[0], len(hits)) if hits else (None, 0)


@pytest.mark.parametrize("seed,n,sigma", [(3, 60, 3), (5, 90, 4)])
def test_bidir_intervals_synchronized(seed, n, sigma):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.int32)
    rev = text[::-1].copy()
    idx = BidirectionalFMIndex.from_text(text, sigma, device="cpu")
    ref = JaxBidir.from_text(text, sigma)
    for _ in range(25):
        w = [int(c) for c in rng.integers(0, sigma, int(rng.integers(1, 6)))]
        lo, lo_rev, size = idx.interval(np.array(w))
        assert (lo, lo_rev, size) == ref.interval(np.array(w))
        olo, osz = _interval_oracle(text, w)
        assert size == osz
        if osz:
            assert lo == olo
            assert lo_rev == _interval_oracle(rev, w[::-1])[0]


def test_bidir_left_right_equivalence():
    rng = np.random.default_rng(11)
    text = rng.integers(0, 4, 70).astype(np.int32)
    idx = BidirectionalFMIndex.from_text(text, 4, device="cpu")
    ref = JaxBidir.from_text(text, 4)
    carried = bidir_from_jax(ref, "cpu")
    for _ in range(20):
        w = rng.integers(0, 4, int(rng.integers(1, 6)))
        assert idx.count(w) == idx.count(w, from_right=True) == ref.count(w)
        assert carried.count(w, from_right=True) == ref.count(
            w, from_right=True)


def test_bidir_mixed_extension_order():
    rng = np.random.default_rng(13)
    text = rng.integers(0, 3, 50).astype(np.int32)
    rev = text[::-1].copy()
    idx = BidirectionalFMIndex.from_text(text, 3, device="cpu")
    ref = JaxBidir.from_text(text, 3)
    for _ in range(15):
        mid = int(rng.integers(0, 3))
        w = [mid]
        st = idx.extend_left([mid], *idx.whole(1))
        rst = ref.extend_left(jnp.asarray([mid]), *ref.whole(1))
        for _step in range(4):
            c = int(rng.integers(0, 3))
            if rng.random() < 0.5:
                st = idx.extend_left([c], *st)
                rst = ref.extend_left(jnp.asarray([c]), *rst)
                w = [c] + w
            else:
                st = idx.extend_right([c], *st)
                rst = ref.extend_right(jnp.asarray([c]), *rst)
                w = w + [c]
        got = [int(x[0]) for x in st]
        assert got == [int(np.asarray(x)[0]) for x in rst]
        olo, osz = _interval_oracle(text, w)
        assert got[2] == osz
        if osz:
            assert got[0] == olo
            assert got[1] == _interval_oracle(rev, w[::-1])[0]


def test_rank_all_matches_per_symbol():
    from bwtb3m_tpu.ops.focc_bp import build_focc_bp
    from bwtb3m_tpu.ops.focc_bp import rank_all_batch_bp as jax_rank_all
    from bwtb3m_tpu_torch.ops.focc import rank
    from bwtb3m_tpu_torch.ops.focc_build import focc_from_jax
    rng = np.random.default_rng(17)
    for sigma in (2, 5, 8):
        n = 20_000
        bwt = rng.integers(0, sigma, n).astype(np.int32)
        jf = build_focc_bp(jnp.asarray(bwt), sigma)
        i = rng.integers(0, n + 1, 1024)
        want = np.asarray(jax_rank_all(jf, jnp.asarray(i.astype(np.uint32))))
        for layout in ("bitplane", "sector") if sigma <= 4 else ("bitplane",):
            focc = (focc_from_jax(jf, "cpu", "bitplane") if layout ==
                    "bitplane" else build_focc_host(bwt.astype(np.uint8),
                                                    sigma, "cpu", layout))
            got = rank_all_batch_bp(focc, torch.from_numpy(i))
            np.testing.assert_array_equal(got.numpy(), want)
            for c in range(sigma):
                one = rank(focc, torch.full((1024,), c), torch.from_numpy(i))
                assert torch.equal(got[:, c], one)


# ------------------------------------------------------------ Hamming search

@pytest.fixture(scope="module")
def pacterm_index(tmp_path_factory):
    from bwtb3m_tpu_torch.io.pac import write_pac
    tmp = tmp_path_factory.mktemp("ham")
    rng = np.random.default_rng(41)
    codes = rng.integers(0, 4, 1500, dtype=np.int32)
    codes[700:760] = codes[100:160]                # a repeat
    pacp = str(tmp / "h.pac")
    write_pac(pacp, codes)
    res = jax_compute_bwt(JaxOptions(input_path=pacp, input_type="pacterm",
                                     sa_sampling_rate=8, isa_sampling_rate=8,
                                     preisa_sampling_rate=128, verbose=0))
    ref = JaxFM.from_bwt_result(res, structure="hwt")
    fm = FMIndex.from_bwt_result(BwtResult.load(res.bwt_path), device="cpu")
    return codes, fm, ref


@pytest.mark.parametrize("maxmis", [0, 1, 2])
def test_hamming_search_list_matches_the_recursion(pacterm_index, maxmis):
    """The breadth-first search gives the reference recursion's list, in
    its order, for single patterns and for a batch of them (reads and
    their reverse complements, of several lengths, a read of the repeat,
    a read with mismatches, a read of length 0)."""
    codes, fm, ref = pacterm_index
    rng = np.random.default_rng(maxmis)
    pats = []
    for a, m in ((100, 20), (705, 12), (3, 9), (1400, 30), (0, 6)):
        p = codes[a:a + m].astype(np.int64).copy()
        if m > 8:
            p[4] = (p[4] + 1) % 4
        pats += [p, (3 - p)[::-1].copy()]
    pats.append(rng.integers(0, 4, 7))
    pats.append(np.zeros(0, np.int64))
    want = [jax_hamming(ref, p, maxmis) for p in pats]
    assert sum(len(w) for w in want) >= 2 + 3 * maxmis
    for p, w in zip(pats, want):
        assert hamming_search(fm, p, maxmis) == w
    pid, lo, hi, nm = hamming_search_batch(fm, pats, maxmis)
    got = [[] for _ in pats]
    for k, a, b, c in zip(pid.tolist(), lo.tolist(), hi.tolist(),
                          nm.tolist()):
        got[k].append((a, b, c))
    assert got == want
    ids = fm.dense_ids(np.arange(4) + 1)              # pacterm bases 1..4
    assert hamming_search_plain(fm.rows, ids, pats, maxmis) == want


# ------------------------------------------------------------ suffix tree

def _cst_pair(text):
    text = np.asarray(text, dtype=np.int64)
    n = len(text)
    sa = naive_circular_sa(text)
    lcp = np.zeros(n, np.int64)
    for i in range(1, n):
        a, b = sa[i - 1], sa[i]
        while lcp[i] < n and text[(a + lcp[i]) % n] == text[(b + lcp[i]) % n]:
            lcp[i] += 1
    return (text, sa, CompressedSuffixTree(lcp, sa=sa, text=text),
            JaxCst(lcp, sa=sa, text=text))


def _nodes(cst):
    out, stack = [], [cst.root]
    while stack:
        v = stack.pop()
        out.append(v)
        stack.extend(cst.children(v))
    return out


@pytest.mark.parametrize("seed,n,sigma", [(1, 40, 3), (2, 60, 2), (3, 80, 4)])
def test_cst_descend_matches_reference(seed, n, sigma):
    rng = np.random.default_rng(seed)
    _text, _sa, cst, ref = _cst_pair(rng.integers(0, sigma, n))
    for _ in range(40):
        w = rng.integers(0, sigma, int(rng.integers(1, 7)))
        assert cst.descend(w) == ref.descend(w)


def test_cst_children_parents_and_depths():
    rng = np.random.default_rng(7)
    _text, _sa, cst, ref = _cst_pair(rng.integers(0, 3, 50))
    nodes = _nodes(cst)
    assert nodes == _nodes(ref)
    assert sum(cst.is_leaf(v) for v in nodes) == 50
    for v in nodes:
        assert cst.children(v) == ref.children(v)
        assert cst.parent(v) == ref.parent(v)
        if not cst.is_leaf(v):
            assert cst.string_depth(v) == ref.string_depth(v)


def test_cst_suffix_link_and_lca():
    rng = np.random.default_rng(11)
    _text, _sa, cst, ref = _cst_pair(rng.integers(0, 3, 60))
    for v in _nodes(cst):
        if not cst.is_leaf(v):
            assert cst.suffix_link(v) == ref.suffix_link(v)
    for _ in range(60):
        a, b = sorted(int(x) for x in rng.integers(0, 60, 2))
        assert cst.lca((a, a), (b, b)) == ref.lca((a, a), (b, b))


def test_cst_from_files(tmp_path):
    from bwtb3m_tpu_torch.io import formats
    from bwtb3m_tpu_torch.lcp.rmm import RMMTree
    from bwtb3m_tpu_torch.lcp.wavelet_lcp import write_ulcp
    rng = np.random.default_rng(17)
    text, sa, cst, _ref = _cst_pair(rng.integers(0, 3, 30))
    base = str(tmp_path / "t")
    write_ulcp(base + ".ulcp", cst.lcp)
    RMMTree(cst.lcp).write(base + ".rmm")
    formats.write_sampled_array(base + ".sa", 1, sa.astype(np.int64))
    mine = CompressedSuffixTree.from_files(base)
    theirs = JaxCst.from_files(base)
    mine.text = theirs.text = text
    for c in range(3):
        assert mine.descend(np.array([c])) == theirs.descend(np.array([c]))
    np.testing.assert_array_equal(mine.lcp, theirs.lcp)


def test_fm_index_on_forced_wide_rows(tmp_path, monkeypatch):
    """Under BWTB3M_FORCE_WIDE the index takes the wide rows of
    ``load_focc`` (the locate and decode walks' 64-bit form on the card)
    and answers as the reference does."""
    from bwtb3m_tpu_torch.engine.result import clear_caches
    from bwtb3m_tpu_torch.ops.wideocc import WideOcc
    rng = np.random.default_rng(23)
    res, pres = _jax_build(tmp_path, bytes(rng.integers(97, 101, 700)
                                           .astype(np.uint8)),
                           sa_sampling_rate=8, isa_sampling_rate=16)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    clear_caches()
    fm = FMIndex.from_bwt_result(pres, device="cpu")
    assert isinstance(fm.rows, WideOcc)
    ref = JaxFM.from_bwt_result(res)
    ranks = np.arange(res.n)
    np.testing.assert_array_equal(fm.locate_batch(ranks),
                                  ref.locate_batch(ranks))
    np.testing.assert_array_equal(fm.extract(690, 30), ref.extract(690, 30))
    assert fm.backward_search([97, 98, 99]) == ref.backward_search([97, 98,
                                                                    99])
    clear_caches()
