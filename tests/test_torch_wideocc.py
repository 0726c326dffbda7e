"""The port's wide rank rows (``ops/wideocc.py``) against the reference's
(``bwtb3m_tpu/ops/wideocc.py``) and against int64 truth.

A 4 G-symbol BWT cannot run here, so, as tests/test_wideocc.py does, the
rows are doctored: a small BWT is taken as the tail of a text with B[c]
earlier occurrences of each symbol, B close to 2^32, so that every
symbol's stored occ word wraps inside the rows.  The reference's
``WideOcc`` carries over to the port in every layout (``wide_from_jax``:
its own rows, or sector rows rebuilt from its symbols and its counts at
row 0), and the port's builder with ``base=B`` makes the same structure.
Wide rank, access and LF step then equal the int64 truth and the
reference's two-word answers.  Then the engine: ``check_bwt``,
``compute_ssa`` and ``compute_isa_from_preisa`` under
``BWTB3M_FORCE_WIDE`` (wide rows, the kernel's 64-bit form on the card,
its plain version here) against the reference's forced-wide runs and the
port's narrow runs, mirroring tests/test_wideocc.py.  Exact equality.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.ops.focc_build import build_focc_host as jax_build_focc
from bwtb3m_tpu.ops.wideocc import (access_batch_w, lf_step_batch_w,
                                    rank_batch_w, widen_focc)
from bwtb3m_tpu_torch.ops import wideocc as pw
from bwtb3m_tpu_torch.ops.focc_build import build_focc_device, build_focc_host

TWO32 = 1 << 32
BLOCK = {"sector": 64, "bitplane": 256, "bytes": 256}
LAYOUT_CASES = [(4, "sector"), (3, "sector"), (4, "bitplane"),
                (7, "bitplane"), (12, "bytes"), (200, "bytes")]


def _true_occ(bwt, sigma, block):
    """Exclusive occ counts at every block start up to the first at or
    past n (int64 [rows, sigma]), and at every position."""
    nb = len(bwt) // block + 2
    pos = np.minimum(np.arange(nb) * block, len(bwt))
    cum = np.zeros((len(bwt) + 1, sigma), np.int64)
    cum[1:] = np.cumsum(bwt[:, None] == np.arange(sigma), 0)
    return cum[pos], cum


def _jax_wide(sigma, n, seed, chunk=64):
    """The reference's doctored WideOcc (tests/test_wideocc.py::_make_wide):
    (bwt, WideOcc, B uint64 [sigma])."""
    rng = np.random.default_rng(seed)
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    focc, bases, g = jax_build_focc(bwt, sigma, chunk_rows=chunk,
                                    return_bases=True)
    occ64, _cum = _true_occ(bwt, sigma, 256)
    nb = (n + 255) // 256
    B = np.zeros(sigma, np.uint64)
    for c in range(sigma):
        r = g + 1 + (c + 1) * (nb - g - 1) // (sigma + 1)
        B[c] = np.uint64(TWO32 - int(occ64[r, c]) - (0 if c == 0 else c))
    rows = np.asarray(focc.rows)
    if rows.shape[1] == 128:                         # bit-plane rows
        from bwtb3m_tpu.ops.focc_bp import NPLANES, FusedOccBP
        w = rows.reshape(len(rows), 32, 4).view(np.uint32).reshape(
            len(rows), 32).copy()
        w[:, NPLANES * 8:NPLANES * 8 + sigma] += B.astype(np.uint32)
        new = FusedOccBP(jnp.asarray(w.view(np.uint8).reshape(
            rows.shape).view(np.int8)), focc.C, focc.n, sigma)
    else:
        from bwtb3m_tpu.ops.focc import FusedOcc
        blk = focc.block
        cw = rows[:, blk:blk + 4 * sigma].copy().view(np.uint32)
        cw += B.astype(np.uint32)
        r2 = rows.copy()
        r2[:, blk:blk + 4 * sigma] = cw.view(np.int8)
        new = FusedOcc(jnp.asarray(r2), focc.C, focc.n, sigma, blk)
    dbases = (bases.astype(np.uint64) + B[None, :]).astype(np.uint32)
    return bwt, widen_focc(new, dbases, g, int(B.sum()) + n), B


def _truth_rank(bwt, sigma, B, c, i):
    _occ, cum = _true_occ(bwt, sigma, 256)
    return B[c].astype(np.int64) + cum[i, c]


@pytest.mark.parametrize("sigma,layout", LAYOUT_CASES)
def test_wide_queries_straddle_2_32(sigma, layout):
    """rank_w / access_w / lf_step_w on the reference's doctored rows,
    carried over in ``layout``, equal the int64 truth and the reference's
    (hi, lo) answers."""
    n = 256 * 300 + 57
    bwt, jw, B = _jax_wide(sigma, n, 11 + sigma)
    w = pw.wide_from_jax(jw, "cpu", layout)
    assert isinstance(w, pw.WideOcc) and w.LAYOUT == layout
    wraps = int((w.thr != pw.THR_PAD).sum())
    assert 0 < wraps <= sigma                    # at most one per symbol
    rng = np.random.default_rng(1)
    i = rng.integers(0, n + 1, 1500)
    c = rng.integers(0, sigma, 1500)
    got = pw.rank_w(w, torch.from_numpy(c), torch.from_numpy(i)).numpy()
    want = _truth_rank(bwt, sigma, B, c, i)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= TWO32 > got.min()
    hi, lo = rank_batch_w(jw, jnp.asarray(c.astype(np.int32)),
                          jnp.zeros(1500, jnp.uint32),
                          jnp.asarray(i.astype(np.uint32)))
    np.testing.assert_array_equal(
        got, (np.asarray(hi, np.int64) << 32) | np.asarray(lo, np.int64))
    j = rng.integers(0, n, 1500)
    jt = torch.from_numpy(j)
    np.testing.assert_array_equal(pw.access_w(w, jt).numpy(), bwt[j])
    np.testing.assert_array_equal(
        pw.access_w(w, jt).numpy(),
        np.asarray(access_batch_w(jw, jnp.zeros(1500, jnp.uint32),
                                  jnp.asarray(j.astype(np.uint32)))))
    sym, r2 = pw.lf_step_w(w, jt)
    s2, h2, l2 = lf_step_batch_w(jw, jnp.zeros(1500, jnp.uint32),
                                 jnp.asarray(j.astype(np.uint32)))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(s2))
    np.testing.assert_array_equal(
        r2.numpy(), (np.asarray(h2, np.int64) << 32)
        | np.asarray(l2, np.int64))
    C64 = np.zeros(sigma + 1, np.int64)
    C64[1:] = np.cumsum(B.astype(np.int64)
                        + np.bincount(bwt, minlength=sigma))
    np.testing.assert_array_equal(w.C.numpy(), C64)


@pytest.mark.parametrize("sigma,layout", LAYOUT_CASES)
def test_builder_with_base_is_the_reference_structure(sigma, layout):
    """The port's builder, given the counts B before position 0, makes the
    rows, wrap rows and C of the reference's doctored structure (in the
    reference's layouts byte for byte; sector rows hold the same counts
    on a grid of 64)."""
    n = 256 * 200 + 3
    bwt, jw, B = _jax_wide(sigma, n, 5 + sigma)
    w = build_focc_device(torch.from_numpy(bwt), sigma, layout, wide=True,
                          base=torch.from_numpy(B.astype(np.int64)))
    ref = pw.wide_from_jax(jw, "cpu", layout)
    assert torch.equal(w.rows, ref.rows) and torch.equal(w.C, ref.C)
    assert torch.equal(w.thr, ref.thr)
    assert torch.equal(w.focc.C, ref.focc.C)
    # the wrap rows are where the exact counts cross 2^32
    occ, _cum = _true_occ(bwt, sigma, BLOCK[layout])
    for c in range(sigma):
        crossed = occ[:, c] + int(B[c]) >= TWO32
        if not crossed.any():
            assert int(w.thr[c, 0]) == pw.THR_PAD
            continue
        first = int(np.argmax(crossed))
        assert int(w.thr[c, 0]) == first
        lo = pw.occ_words_from_row(w.focc, w.rows[first])
        assert int(lo[c]) == int(occ[first, c] + int(B[c])) - TWO32


def test_counts_from_2_32_and_a_second_wrap():
    """A base at or above 2^32 puts wrap rows at row 0 (hi word from the
    first row on), and a count that crosses 2^33 inside the rows gives a
    second wrap row; more than THR_K wraps are refused."""
    rng = np.random.default_rng(3)
    bwt = rng.integers(0, 4, 5000).astype(np.uint8)
    cnt = np.bincount(bwt, minlength=4)
    B = np.array([TWO32 + 5, 2 * TWO32 - 10, 0, 3 * TWO32], np.int64)
    for layout in ("sector", "bitplane"):
        w = build_focc_device(torch.from_numpy(bwt), 4, layout, wide=True,
                              base=torch.from_numpy(B))
        assert w.thr[0].tolist()[:2] == [0, pw.THR_PAD]
        assert w.thr[1, 0] == 0 and 0 < w.thr[1, 1] < pw.THR_PAD
        assert w.thr[3].tolist()[:4] == [0, 0, 0, pw.THR_PAD]
        assert (w.thr[2] == pw.THR_PAD).all()
        i = torch.from_numpy(rng.integers(0, 5001, 700))
        for c in range(4):
            cc = torch.full_like(i, c)
            want = B[c] + np.array([(bwt[:k] == c).sum() for k in i.numpy()])
            np.testing.assert_array_equal(pw.rank_w(w, cc, i).numpy(), want)
        np.testing.assert_array_equal(w.C[1:].numpy(), np.cumsum(B + cnt))
    with pytest.raises(ValueError, match="wraps its occ word"):
        build_focc_device(torch.from_numpy(bwt), 4, "sector", wide=True,
                          base=torch.tensor([9 * TWO32, 0, 0, 0]))


def test_no_wraps_below_2_32():
    rng = np.random.default_rng(5)
    bwt = rng.integers(0, 5, 70_000).astype(np.uint8)
    w = build_focc_host(bwt, 5, "cpu", wide=True)
    assert (w.thr == pw.THR_PAD).all()
    narrow = build_focc_host(bwt, 5, "cpu")
    assert torch.equal(w.rows, narrow.rows)
    assert torch.equal(w.focc.C, narrow.C)
    r = torch.arange(len(bwt))
    assert torch.equal(pw.lf_step_w(w, r)[1],
                       __import__("bwtb3m_tpu_torch.ops.focc",
                                  fromlist=["lf_step"]).lf_step(narrow, r)[1])


@pytest.mark.parametrize("layout", ["sector", "bitplane", "bytes"])
def test_doctored_rows_walk_like_the_undoctored(layout):
    """``doctored``: every rank query reads a hi word, yet an LF walk
    visits the ranks of the undoctored rows (C lowered by the base)."""
    from bwtb3m_tpu_torch.ops import lf_walk as lw
    from bwtb3m_tpu_torch.ops.doubling import suffix_array
    sigma = 200 if layout == "bytes" else 4
    rng = np.random.default_rng(9)
    text = rng.integers(0, sigma, 20_011).astype(np.uint8)
    _sa, isa, bwt = suffix_array(text, sigma, "cpu")
    bwt_t = torch.from_numpy(bwt.astype(np.uint8))
    cnt = np.bincount(bwt, minlength=sigma)
    B = torch.from_numpy((TWO32 - cnt // 2).astype(np.int64))
    w = pw.doctored(bwt_t, sigma, layout, B)
    assert int((w.thr != pw.THR_PAD).sum()) == int((cnt > 0).sum())
    narrow = build_focc_device(bwt_t, sigma, layout)
    r0 = torch.from_numpy(isa[::97].astype(np.int64))
    assert torch.equal(lw.lf_walk_plain(w, r0, 300),
                       lw.lf_walk_plain(narrow, r0, 300))


# ------------------------------------------------------------------ engine

def _jax_build(tmp_path, data, **kw):
    from bwtb3m_tpu.engine import BwtOptions, compute_bwt
    inp = str(tmp_path / "t.bin")
    open(inp, "wb").write(data)
    return inp, compute_bwt(BwtOptions(input_path=inp, verbose=0, **kw))


def test_check_bwt_forced_wide(tmp_path, monkeypatch):
    """tests/test_wideocc.py::test_check_bwt_wide_kernel for the port:
    under BWTB3M_FORCE_WIDE the rows are wide, a good BWT checks and a
    corrupted one does not, as in the reference's forced-wide run."""
    from bwtb3m_tpu.engine import check_bwt as jax_check
    from bwtb3m_tpu_torch.engine.result import BwtResult
    from bwtb3m_tpu_torch.engine.verify import check_bwt
    from bwtb3m_tpu_torch.io import rl

    rng = np.random.default_rng(17)
    data = bytes(rng.integers(97, 102, size=4096, dtype=np.uint8))
    _inp, jres = _jax_build(tmp_path, data, preisa_sampling_rate=256)
    text = np.frombuffer(data, np.uint8)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    res = BwtResult.load(jres.bwt_path)
    focc, _ = res.load_focc("cpu")
    assert isinstance(focc, pw.WideOcc)
    assert check_bwt(res, text, device="cpu")
    assert jax_check(jres, text.astype(np.int32))
    bwt = res.load_bwt()
    i = int(np.flatnonzero(bwt[1:] != bwt[:-1])[0])
    bwt[i], bwt[i + 1] = bwt[i + 1], bwt[i]
    rl.rl_encode(res.bwt_path, bwt, sigma=res.sigma)
    assert not check_bwt(BwtResult.load(res.bwt_path), text, device="cpu")
    assert not jax_check(jres, text.astype(np.int32))


def test_compute_ssa_forced_wide(tmp_path, monkeypatch):
    """The forced-wide harvest writes the .sa/.isa bytes of the
    reference's forced-wide run and of the port's narrow run."""
    from bwtb3m_tpu.engine import compute_ssa as jax_ssa
    from bwtb3m_tpu_torch.engine.ssa import compute_ssa

    rng = np.random.default_rng(23)
    data = bytes(rng.integers(97, 101, size=8192, dtype=np.uint8))
    _inp, jres = _jax_build(tmp_path, data, bwt_only=True,
                            preisa_sampling_rate=512)
    base = jres.bwt_path[:-4]

    def files():
        return [open(base + e, "rb").read() for e in (".sa", ".isa")]

    compute_ssa(jres.bwt_path, 32, 64, device="cpu")
    narrow = files()
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    compute_ssa(jres.bwt_path, 32, 64, device="cpu")
    wide = files()
    jax_ssa(jres.bwt_path, 32, 64)
    assert wide == narrow == files()
    with pytest.raises(ValueError, match="power-of-two"):
        compute_ssa(jres.bwt_path, 24, 64, device="cpu")


def test_compute_isa_from_preisa_forced_wide(tmp_path, monkeypatch):
    from bwtb3m_tpu.engine.ssa import compute_isa_from_preisa as jax_isa
    from bwtb3m_tpu_torch.engine.ssa import compute_isa_from_preisa

    rng = np.random.default_rng(29)
    data = bytes(rng.integers(97, 103, size=5000, dtype=np.uint8))
    _inp, jres = _jax_build(tmp_path, data, bwt_only=True,
                            preisa_sampling_rate=256)
    isa_n = open(compute_isa_from_preisa(jres.bwt_path, 64, device="cpu"),
                 "rb").read()
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    isa_w = open(compute_isa_from_preisa(jres.bwt_path, 64, device="cpu"),
                 "rb").read()
    assert isa_w == isa_n == open(jax_isa(jres.bwt_path, 64), "rb").read()
