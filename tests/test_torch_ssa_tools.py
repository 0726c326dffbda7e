"""The rest of the sampled-SA tool group against the reference package.

After ``tests/test_engine.py`` (``test_hwt_preisa_to_isa``,
``test_select_ssa``, ``test_select_ssa_bwtonly``) and
``tests/test_plcp_device.py::test_compute_sa_device``: ``select_ssa``
(also on a ``bwtonly=1`` build, for ranks that are themselves ``.preisa``
ranks, rank 0 and duplicates, on sector, bit-plane and byte rows),
``compute_sa_device`` against the full suffix array, ``hwtPreIsaToIsa``
against the reference tool's ``.isa`` bytes, ``sortPreIsa`` and
``sasubsample`` byte for byte, and the select walk's plain version
against the reference's ``_select_chunk``; the select kernel's summary
bitmap (``select_summary``) against the blocks that hold a mark.  Exact
equality; on the CPU the walks run their plain versions.
"""

import filecmp

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.engine.ssa import _select_chunk
from bwtb3m_tpu.engine.ssa import select_ssa as jax_select_ssa
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.ops.focc_build import build_focc_host as jax_build_focc
from bwtb3m_tpu_torch.cli import TOOLS, dispatch
from bwtb3m_tpu_torch.engine import (BwtOptions, compute_bwt,
                                     compute_isa_from_preisa,
                                     compute_sa_device, select_ssa)
from bwtb3m_tpu_torch.io import formats
from bwtb3m_tpu_torch.ops.focc_build import focc_from_jax
from bwtb3m_tpu_torch.ops.lf_walk import (select_summary, select_walk,
                                          select_walk_plain)


def _build(tmp_path, name, lo, hi, n, seed, **kw):
    rng = np.random.default_rng(seed)
    data = rng.integers(lo, hi, n).astype(np.uint8)
    inp = str(tmp_path / name)
    data.tofile(inp)
    res = compute_bwt(BwtOptions(input_path=inp, verbose=0, device="cpu",
                                 **kw))
    sa = np.asarray(jax_suffix_array(data.astype(np.int32), 256)[0])
    return res, data, sa, rng


@pytest.mark.parametrize("lo,hi", [(97, 101), (97, 104), (40, 240)])
def test_select_ssa(tmp_path, lo, hi):
    # 4 / 7 / 200 symbols: sector, bit-plane and byte rows
    res, data, sa, rng = _build(tmp_path, "sel.bin", lo, hi, 1200, 17,
                                sa_sampling_rate=16, isa_sampling_rate=16)
    wanted = rng.integers(0, len(data), 40)
    got = select_ssa(res.bwt_path, wanted, device="cpu")
    np.testing.assert_array_equal(got, sa[wanted])
    np.testing.assert_array_equal(got, jax_select_ssa(res.bwt_path, wanted))


def test_select_ssa_bwtonly(tmp_path):
    res, data, sa, rng = _build(tmp_path, "selb.bin", 97, 101, 3000, 23,
                                bwt_only=True, preisa_sampling_rate=128)
    assert res.sa_path is None
    wanted = np.unique(rng.integers(0, len(data), 100))
    np.testing.assert_array_equal(
        select_ssa(res.bwt_path, wanted, device="cpu"), sa[wanted])
    # ranks that are themselves preisa ranks resolve with zero steps
    pr_r, _pp, _ = res.load_preisa()
    np.testing.assert_array_equal(
        select_ssa(res.bwt_path, pr_r[:8], device="cpu"), sa[pr_r[:8]])
    # rank 0, the last rank, duplicates, and no rank at all
    odd = np.array([0, len(data) - 1, 5, 5, 0, 1777, 1777])
    np.testing.assert_array_equal(
        select_ssa(res.bwt_path, odd, device="cpu"), sa[odd])
    assert len(select_ssa(res.bwt_path, np.zeros(0, np.int64),
                          device="cpu")) == 0
    with pytest.raises(ValueError):
        select_ssa(res.bwt_path, [len(data)], device="cpu")


def test_select_ssa_on_a_merge_build(tmp_path):
    res, data, sa, rng = _build(
        tmp_path, "selm.bin", 97, 101, 5000, 29, bwt_only=True,
        engine="merge", max_block_symbols=2048, preisa_sampling_rate=256,
        lane_bucket=32)
    wanted = rng.integers(0, len(data), 64)
    np.testing.assert_array_equal(
        select_ssa(res.bwt_path, wanted, device="cpu"), sa[wanted])


@pytest.mark.parametrize("sigma,layout", [(4, "sector"), (4, "bitplane"),
                                          (200, "bytes")])
def test_select_walk_plain_matches_reference_chunk(sigma, layout):
    rng = np.random.default_rng(sigma)
    n = 3000
    text = rng.integers(0, sigma, n).astype(np.int32)
    sa, isa, bwt = (np.asarray(a) for a in jax_suffix_array(text, sigma))
    jfocc = jax_build_focc(bwt.astype(np.uint8), sigma)
    marks = isa[::97]
    words = np.zeros(n // 32 + 1, np.uint32)
    np.bitwise_or.at(words, marks >> 5,
                     np.uint32(1) << (marks & 31).astype(np.uint32))
    T = 1024
    r0 = rng.integers(0, n, T)
    rj, dj, rh, kh = _select_chunk(
        1, jfocc, jnp.asarray(words), jnp.asarray(r0.astype(np.uint32)),
        jnp.zeros(T, bool), jnp.zeros(T, jnp.uint32),
        jnp.zeros(T, jnp.uint32), jnp.int32(0))
    assert bool(np.asarray(dj).all())
    focc = focc_from_jax(jfocc, layout=layout)
    bitwords = torch.from_numpy(words.view(np.int32))
    r_hit, steps = select_walk(focc, bitwords, torch.from_numpy(r0), 256)
    np.testing.assert_array_equal(r_hit.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(kh))
    assert int(steps.max()) <= 97 and int(steps.min()) == 0
    # a cap below the longest walk: those lanes report -1
    r_cap, s_cap = select_walk_plain(focc, bitwords, torch.from_numpy(r0),
                                     10)
    late = np.asarray(kh) >= 10
    assert late.any() and (s_cap.numpy()[late] == -1).all()
    np.testing.assert_array_equal(s_cap.numpy()[~late],
                                  np.asarray(kh)[~late])
    np.testing.assert_array_equal(r_cap.numpy()[~late],
                                  np.asarray(rh)[~late])


def test_compute_sa_device(tmp_path):
    res, data, sa, _rng = _build(tmp_path, "t.bin", 97, 101, 4096, 9,
                                 bwt_only=True, preisa_sampling_rate=256)
    sa_dev, n = compute_sa_device(res.bwt_path, device="cpu")
    assert n == len(data) and sa_dev.device.type == "cpu"
    np.testing.assert_array_equal(sa_dev.numpy(), sa)


def test_hwt_preisa_to_isa_matches_reference_tool(tmp_path):
    rng = np.random.default_rng(11)
    data = rng.integers(65, 70, 2048).astype(np.uint8)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        data.tofile(str(tmp_path / d / "t.bin"))
    jax_compute_bwt(JaxOptions(input_path=str(tmp_path / "jax/t.bin"),
                               bwt_only=True, preisa_sampling_rate=200,
                               verbose=0))
    compute_bwt(BwtOptions(input_path=str(tmp_path / "port/t.bin"),
                           bwt_only=True, preisa_sampling_rate=200,
                           verbose=0, device="cpu"))
    assert jax_dispatch(["hwtPreIsaToIsa", "isasamplingrate=64", "verbose=0",
                         str(tmp_path / "jax/t.bin.bwt")]) == 0
    assert dispatch(["hwtPreIsaToIsa", "isasamplingrate=64", "verbose=0",
                     "device=cpu", str(tmp_path / "port/t.bin.bwt")]) == 0
    assert filecmp.cmp(tmp_path / "jax/t.bin.isa", tmp_path / "port/t.bin.isa",
                       shallow=False)
    isa = np.zeros(len(data), np.int64)
    sa = np.asarray(jax_suffix_array(data.astype(np.int32), 256)[0])
    isa[sa] = np.arange(len(sa))
    rate, vals = formats.read_sampled_array(str(tmp_path / "port/t.bin.isa"))
    assert rate == 64
    np.testing.assert_array_equal(vals, isa[::64])
    # the entry point itself, at another rate; a bad rate is refused
    path = compute_isa_from_preisa(str(tmp_path / "port/t.bin.bwt"), 16,
                                   device="cpu")
    np.testing.assert_array_equal(formats.read_sampled_array(path)[1],
                                  isa[::16])
    assert dispatch(["hwtPreIsaToIsa", "isasamplingrate=48", "device=cpu",
                     str(tmp_path / "port/t.bin.bwt")]) == 1


def test_sort_preisa_and_sasubsample_match_reference_tools(tmp_path):
    res, data, sa, rng = _build(tmp_path, "s.bin", 97, 101, 4000, 31,
                                sa_sampling_rate=8, isa_sampling_rate=64,
                                preisa_sampling_rate=128)
    # a shuffled .preisa: sortPreIsa puts it back in position order
    ranks, poss, rate = formats.read_preisa(res.preisa_path)
    perm = rng.permutation(len(poss))
    shuffled = str(tmp_path / "shuf.preisa")
    formats.write_preisa(shuffled, ranks[perm], poss[perm], rate)
    assert dispatch(["sortPreIsa", "verbose=0",
                     "outputfilename=%s" % (tmp_path / "p.sorted"),
                     shuffled]) == 0
    assert jax_dispatch(["sortPreIsa", "verbose=0",
                         "outputfilename=%s" % (tmp_path / "j.sorted"),
                         shuffled]) == 0
    assert filecmp.cmp(tmp_path / "p.sorted", tmp_path / "j.sorted",
                       shallow=False)
    assert filecmp.cmp(tmp_path / "p.sorted", res.preisa_path, shallow=False)
    # duplicate positions are refused by both
    dup = str(tmp_path / "dup.preisa")
    formats.write_preisa(dup, ranks[[0, 1, 1]], poss[[0, 1, 1]], rate)
    assert dispatch(["sortPreIsa", "verbose=0", dup]) == 1
    assert jax_dispatch(["sortPreIsa", "verbose=0", dup]) == 1

    assert dispatch(["sasubsample", "-s4", res.sa_path,
                     str(tmp_path / "p.sa")]) == 0
    assert jax_dispatch(["sasubsample", "-s4", res.sa_path,
                         str(tmp_path / "j.sa")]) == 0
    assert filecmp.cmp(tmp_path / "p.sa", tmp_path / "j.sa", shallow=False)
    rate4, vals = formats.read_sampled_array(str(tmp_path / "p.sa"))
    assert rate4 == 32
    np.testing.assert_array_equal(vals, sa[::32])
    assert dispatch(["sasubsample", "-s3", res.sa_path,
                     str(tmp_path / "x.sa")]) == 1


def test_tools_are_listed_as_ported():
    assert sorted(TOOLS) == sorted([
        "bwtb3m", "checkbwt", "bwtcomputessa", "hwtPreIsaToIsa",
        "sortPreIsa", "sasubsample", "lcpbit", "hwtToLCP", "checkLCPBit",
        "bwttestdecodespeed", "bwtdecodeblock", "bwtb3mdecoderl",
        "probeScanDna", "allHamDna", "bwttohwt", "hwtToRlHwt",
        "bwttodnarank", "bwttodnarank256", "bwtb3mtobwa", "arraytocompact",
        "fa4suffixarraytocompact", "fagzToCompact", "fagzToCompact4",
        "fagzToCompactUTerm", "fagzToCompact4BigBand",
        "fagzToCompact4BigBandBiDir", "digitsToCompact", "decodecompact",
        "bytestreamToLz4"])


def _bitmap(marks, n):
    words = np.zeros(n // 32 + 1, np.uint32)
    np.bitwise_or.at(words, marks >> 5,
                     np.uint32(1) << (marks & 31).astype(np.uint32))
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("n,shift", [
    (1 << 16, 8), ((1 << 16) + 37, 8), (100_003, 5), (100_003, 11),
    (255, 8), (257, 8), (70_000, 12)])
def test_select_summary_sets_the_blocks_that_hold_a_mark(n, shift):
    """Bit b of the summary is set where ranks [b << shift, (b + 1) <<
    shift) hold a mark and nowhere else, with marks at block edges, at
    rank 0, at rank n - 1 and n no multiple of 2^shift; every rank's
    summary word exists."""
    rng = np.random.default_rng(n + shift)
    blk = 1 << shift
    edges = np.arange(0, n, blk)
    marks = np.unique(np.r_[0, n - 1, edges[1::3], edges[2::5] - 1,
                            rng.integers(0, n, 40)])
    marks = marks[(marks >= 0) & (marks < n)]
    summ = select_summary(_bitmap(marks, n), shift)
    assert summ.dtype == torch.int32
    bits = np.unpackbits(summ.numpy().view(np.uint8), bitorder="little")
    nblk = -(-(n // 32 + 1) * 32 // blk)
    assert len(bits) >= nblk and len(bits) * blk > n - 1
    want = np.zeros(len(bits), np.uint8)
    want[marks >> shift] = 1
    np.testing.assert_array_equal(bits, want)
    assert bits[0] == 1 and bits[(n - 1) >> shift] == 1
    # no mark: no bit
    empty = select_summary(_bitmap(np.zeros(0, np.int64), n), shift)
    assert int(empty.abs().sum()) == 0


def test_select_summary_refuses_blocks_below_a_word():
    with pytest.raises(ValueError, match="whole bitmap words"):
        select_summary(_bitmap(np.array([3]), 100), 4)
