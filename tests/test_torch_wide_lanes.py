"""Ranks, positions and counts from 2^31 to 2^32 on the narrow kernels,
and the gates of the wide path.

The narrow kernel forms keep ranks and positions in uint32, which torch
carries as int32 bit patterns: every value from 2^31 on reads as a
negative int32.  These tests hold each host conversion to int64 truth at
and above 2^31 (the lanes and samples of ``ops/lf_walk.py``, C and the
occ words of the rank rows, the ``.sa``/``.isa``/``.preisa`` writers
against the reference's), with a rank base of 2^31 + 2^20 where a base
is needed, as tests/test_torch_gapbatch.py's level test has; the memo
key of the rank rows, which must keep narrow and wide rows apart; and
where the gates now sit: ``select_ssa`` at 2^32 (past it the port answers
as the reference does, through the FM index's locate),
``compute_sa_device`` at 2^31 (as the reference's); the build's gate at
2^35 is tests/test_torch_gapwide.py's.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.io import formats as jformats
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.engine.result import BwtResult, clear_caches
from bwtb3m_tpu_torch.io import formats
from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops import wideocc as pw
from bwtb3m_tpu_torch.ops.focc import (as_u32_bits, from_u32_bits, lf_step,
                                       rank)
from bwtb3m_tpu_torch.ops.focc_build import build_focc_device

BASE = (1 << 31) + (1 << 20)
TWO32 = 1 << 32


def test_lane_and_sample_conversions_at_and_above_2_31():
    """Lanes go to the narrow launch as uint32 bits and samples come back
    as int64: every value in [0, 2^32 - 1) survives, 0xFFFFFFFF (no rank
    or position below 2^32) reads as -1, unvisited."""
    v = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, BASE, TWO32 - 2,
                      TWO32 - 1])
    (bits,) = lw._lanes([v], False)
    assert bits.dtype == torch.int32 and int(bits[3]) < 0
    np.testing.assert_array_equal(from_u32_bits(bits).numpy(), v.numpy())
    got = lw._samples(bits).numpy()
    np.testing.assert_array_equal(got[:-1], v.numpy()[:-1])
    assert got[-1] == -1
    (w64,) = lw._lanes([v], True)
    assert w64.dtype == torch.int64 and torch.equal(w64, v)
    np.testing.assert_array_equal(as_u32_bits(v + TWO32).numpy(),
                                  bits.numpy())
    with pytest.raises(ValueError, match="2\\^31 steps"):
        lw._steps_i32(torch.tensor([1 << 31]))
    # the narrow form's rates travel as C ints holding uint32 bits: an
    # ISA-only walk at n = 2^31 + 2^20 passes sarate = n
    assert lw._u32_arg(BASE) == BASE - TWO32
    assert lw._u32_arg(7) == 7
    with pytest.raises(ValueError, match="2\\^32"):
        lw._u32_arg(TWO32)


@pytest.mark.parametrize("layout", ["sector", "bitplane", "bytes"])
def test_rows_with_counts_and_C_above_2_31(layout):
    """Narrow rows of a BWT taken as the tail of a text with 2^31 + 2^20
    earlier occurrences of each symbol: occ words and C are uint32 bits
    (C holds int32 bits of values past 2^31), and the plain rank and LF
    step read them as the int64 truth."""
    sigma = 200 if layout == "bytes" else 4
    rng = np.random.default_rng(4)
    bwt = rng.integers(0, sigma, 9001).astype(np.uint8)
    base = torch.full((sigma,), BASE // sigma, dtype=torch.int64)
    f = build_focc_device(torch.from_numpy(bwt), sigma, layout, base=base)
    cnt = np.bincount(bwt, minlength=sigma)
    C = np.concatenate([[0], np.cumsum(cnt + BASE // sigma)])
    assert C.max() > 1 << 31 and f.C.dtype == torch.int32
    np.testing.assert_array_equal(from_u32_bits(f.C).numpy(), C)
    i = torch.from_numpy(rng.integers(0, len(bwt), 500))
    sym, r2 = lf_step(f, i)
    want = np.array([(bwt[:k] == bwt[k]).sum() for k in i.numpy()])
    np.testing.assert_array_equal(
        r2.numpy(), C[bwt[i.numpy()]] + BASE // sigma + want)
    c = torch.from_numpy(rng.integers(0, sigma, 500))
    want = BASE // sigma + np.array(
        [(bwt[:k] == cc).sum() for k, cc in zip(i.numpy(), c.numpy())])
    np.testing.assert_array_equal(rank(f, c, i).numpy(), want)


def test_poly_a_left_block_fills_one_uint32_cell(monkeypatch):
    """A poly-A left block against a right block without A: every left
    suffix sorts below every right one, so the whole block lands in cell
    0 of the narrow chain's histogram, and the merge equals the
    reference's.  The narrow cells are uint32 held as int32: from a left
    block of 2^31 symbols on, that cell's bits read negative as int32,
    and the zip's cumsum (``gap_cum``) must read the count, up to the
    narrow chain's largest left block, 2^32 - 1 symbols."""
    from bwtb3m_tpu.engine import merge_scaled as jms
    from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
    from bwtb3m_tpu.util.log import VerboseLog
    from bwtb3m_tpu_torch.engine import merge_scaled as ms
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    from bwtb3m_tpu_torch.ops.devzip import cnt_le_at_ranks, gap_cum
    from bwtb3m_tpu_torch.util.phases import Phases
    rng = np.random.default_rng(21)
    block, rate = 2048, 64
    text = np.concatenate([np.zeros(block, np.uint8),
                           rng.integers(1, 4, block).astype(np.uint8)])
    jctx = jms._Ctx(text, 4, rate, JaxOptions(
        input_path="x", max_block_symbols=block), VerboseLog(0), 64)
    pctx = ms._Ctx(text, 4, rate, BwtOptions(
        input_path="x", max_block_symbols=block, device="cpu"), None, 64,
        torch.device("cpu"), Phases("cpu"))
    jl = jms._sort_block_scaled(jctx, 0, block)
    jr = jms._sort_block_scaled(jctx, block, 2 * block)
    cells = []
    compute = gb.BatchedGapRunner.compute

    def spy(self, *a, **kw):
        compute(self, *a, **kw)
        cells.append(self.gap.clone())

    monkeypatch.setattr(gb.BatchedGapRunner, "compute", spy)
    got, = ms._merge_pairs(pctx, [(ms.region_from_jax(jl, 4),
                                   ms.region_from_jax(jr, 4))])
    want = ms.region_from_jax(jms._merge_pair_scaled(jctx, jl, jr), 4)
    assert got.r_start == want.r_start
    np.testing.assert_array_equal(ms._region_bwt(pctx, got),
                                  ms._region_bwt(pctx, want))
    for name in ("samp_pos", "samp_rank", "hist"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    gap, = cells
    assert gap.dtype == torch.int32
    assert int(gap[0]) == block and int(gap[1:].abs().sum()) == 0
    for left in (1 << 31, BASE, TWO32 - 1):
        big = gap.clone()
        big[0] = as_u32_bits(torch.tensor([left]))[0]
        assert int(big[0]) < 0
        cum = gap_cum(big)
        assert cum.dtype == torch.int64
        assert int(cum[0]) == int(cum[-1]) == left
        np.testing.assert_array_equal(
            cnt_le_at_ranks(big, np.array([0, 7, len(gap) - 1])),
            [left] * 3)
        assert torch.equal(big, gap_cum(big).diff(prepend=torch.zeros(
            1, dtype=torch.int64)).to(torch.int32))


def test_writers_past_2_31_and_2_32(tmp_path):
    """.sa / .isa / .preisa values at and above 2^31 and 2^32 are written
    byte for byte as the reference writes them and read back unharmed."""
    vals = np.array([0, (1 << 31) - 1, 1 << 31, BASE, TWO32 - 2, TWO32,
                     (1 << 35) - 1], np.int64)
    for mod, tag in ((formats, "port"), (jformats, "ref")):
        mod.write_sampled_array(str(tmp_path / (tag + ".sa")), 32, vals)
        mod.write_preisa(str(tmp_path / (tag + ".preisa")), vals,
                         vals[::-1].copy(), 4096)
    for ext in (".sa", ".preisa", ".preisa.meta"):
        assert open(tmp_path / ("port" + ext), "rb").read() == \
            open(tmp_path / ("ref" + ext), "rb").read()
    rate, got = formats.read_sampled_array(str(tmp_path / "port.sa"))
    assert rate == 32
    np.testing.assert_array_equal(got, vals)
    r, p, rate = formats.read_preisa(str(tmp_path / "port.preisa"))
    np.testing.assert_array_equal(r, vals)
    np.testing.assert_array_equal(p, vals[::-1])


def _build(tmp_path, n=6000, **kw):
    rng = np.random.default_rng(11)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    inp = str(tmp_path / "t.bin")
    text.tofile(inp)
    return text, compute_bwt(BwtOptions(input_path=inp, device="cpu",
                                        verbose=0, bwt_only=True, **kw))


def test_memo_keeps_narrow_and_wide_rows_apart(tmp_path, monkeypatch):
    """The rank-row memo's key carries the variant: narrow rows never
    serve a wide request (BWTB3M_FORCE_WIDE) nor the other way round, and
    the build's device symbols (the hand-off) serve a wide request
    too."""
    clear_caches()
    _text, res = _build(tmp_path, engine="merge", mem=32768)
    assert res._device_rows is not None
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    wide, _ = res.load_focc("cpu")
    assert isinstance(wide, pw.WideOcc) and res._device_rows is None
    monkeypatch.delenv("BWTB3M_FORCE_WIDE")
    narrow, _ = res.load_focc("cpu")
    assert not isinstance(narrow, pw.WideOcc)
    assert torch.equal(narrow.rows, wide.rows)
    assert res.load_focc("cpu", wide=True)[0] is not narrow
    assert res.load_focc("cpu", wide=False)[0] is not wide
    clear_caches()


def _fake_result(tmp_path, n):
    """A result whose .meta names n symbols and no other file."""
    base = str(tmp_path / "big")
    meta = {"format": "bwtb3m_tpu/v1", "n": n, "sigma": 4,
            "files": {"bwt": base + ".bwt", "preisa": base + ".preisa",
                      "hist": base + ".hist"}}
    with open(base + ".meta", "w") as f:
        json.dump(meta, f)
    open(base + ".bwt", "wb").close()
    return base + ".bwt"


def test_select_gate_at_2_32(tmp_path, monkeypatch):
    """select_ssa from n = 2^32 raises ValueError without a sampled .sa,
    as the reference does; with one it answers, as the reference does,
    through FMIndex.locate_batch over the result's rows (the wide rows
    there: the locate walk's 64-bit form), which takes the ranks as they
    are.  It no longer refuses the band from 2^31: there it goes on to
    read the .preisa (missing here)."""
    from bwtb3m_tpu_torch.engine.ssa import select_ssa
    from bwtb3m_tpu_torch.index import fm as fm_mod
    path = _fake_result(tmp_path, TWO32)
    with pytest.raises(ValueError, match="needs a sampled .sa"):
        select_ssa(path, np.zeros(1, np.int64), device="cpu")
    meta = json.load(open(path[:-4] + ".meta"))
    meta["files"]["sa"] = path[:-4] + ".sa"
    with open(path[:-4] + ".meta", "w") as f:
        json.dump(meta, f)
    seen = []

    class Located:
        def locate_batch(self, ranks):
            return np.asarray(ranks) + 7

    def from_bwt_result(result, structure="hwt", device="cuda"):
        seen.append((result.n, structure, str(device)))
        return Located()

    monkeypatch.setattr(fm_mod.FMIndex, "from_bwt_result",
                        staticmethod(from_bwt_result))
    want = np.array([0, TWO32 - 1, TWO32 // 3], np.int64)
    np.testing.assert_array_equal(select_ssa(path, want, device="cpu"),
                                  want + 7)
    assert seen == [(TWO32, "hwt", "cpu")]
    with pytest.raises(ValueError, match="out of range"):
        select_ssa(path, np.array([TWO32]), device="cpu")
    with pytest.raises(FileNotFoundError):
        select_ssa(_fake_result(tmp_path, BASE), np.zeros(1, np.int64),
                   device="cpu")


def test_ssa_tools_gates(tmp_path):
    """compute_ssa and hwtPreIsaToIsa run past 2^31 and 2^32 (they go on
    to the .preisa, missing here); compute_sa_device keeps the
    reference's 2^31 gate."""
    from bwtb3m_tpu_torch.engine.ssa import (compute_isa_from_preisa,
                                             compute_sa_device, compute_ssa)
    for n in (BASE, TWO32 + 5):
        path = _fake_result(tmp_path, n)
        with pytest.raises(FileNotFoundError):
            compute_ssa(path, 32, 64, device="cpu")
        with pytest.raises(FileNotFoundError):
            compute_isa_from_preisa(path, 64, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        compute_sa_device(_fake_result(tmp_path, BASE), device="cpu")


def test_wide_sa_rate_rules():
    """Past 2^32 the reference's rules for the SA rate (a power of two of
    at least 4, or n and more for an ISA-only walk) and its 2^31 bound on
    the sampled SA."""
    from bwtb3m_tpu_torch.engine.ssa import _wide_sa_rate
    n = TWO32 + 5
    assert _wide_sa_rate(32, n) == 32
    assert _wide_sa_rate(n, n) == 1 << 33
    for bad in (1, 2, 24, 100):
        with pytest.raises(ValueError, match="power-of-two"):
            _wide_sa_rate(bad, n)
    with pytest.raises(ValueError, match="2\\^31 entries"):
        _wide_sa_rate(4, (1 << 33) + 8)
