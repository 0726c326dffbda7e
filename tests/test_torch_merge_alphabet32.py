"""The port past 65,536 distinct symbols against the JAX package.

Past 65,536 distinct symbols the port's dense ids are uint32: 32-bit
regions, window sorts over 32-bit symbols, the native comparator's
uint32 form for the gt bits, and wavelet rank rows of 6 or 7 levels
(``ops/wavelet_rows.py``; on the card the uint32 forms of
``bwt_lf_walk_wm`` and ``bwt_gap_chain_mk_wm``, here their plain
versions).  The text: 70,000 code points over 66,000 distinct ones,
dense from U+0100 with the surrogates skipped (so that the reference's
``OccTable``, an int32 count of every symbol per 128-symbol block, stays
small), in small blocks (``mem=`` 2^18: five blocks of 16,384 symbols).

The reference's legacy engine takes about two minutes at this size, so
the port's merge builds are held to the reference's ``engine=doubling``
files, computed once per module: the BWT of a text without equal
rotations is unique.  Its ``compute_ssa`` gives the ``.sa`` and ``.isa``
that the port's ``bwtonly=0`` builds and SA tools are held to, its
``suffix_array`` the SA that ``select_ssa`` and ``locate_batch`` are
held to; its ``check_bwt`` and ``FMIndex`` run once.  The reference's
``extract`` walks one host step at a time (about half a second a step
here), so it decodes 8 symbols that end on an ISA sample, and the text
is the oracle of the port's longer ranges, of ``bwtdecodeblock`` and of
``bwttestdecodespeed``.  At 300,000 symbols over 270,000 distinct ones
(7 levels; the reference's ``OccTable`` would take gigabytes) the plain
rows are held to a numpy oracle and the merge build to the port's
``engine=doubling``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import check_bwt as jax_check_bwt
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.engine import compute_ssa as jax_compute_ssa
from bwtb3m_tpu.engine.result import BwtResult as JaxResult
from bwtb3m_tpu.index.fm import FMIndex as JaxFMIndex
from bwtb3m_tpu.io.inputtypes import parse_input_type as jax_input_type
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt, compute_ssa)
from bwtb3m_tpu_torch.engine import merge_scaled as ms
from bwtb3m_tpu_torch.engine.ssa import (compute_isa_from_preisa,
                                         load_sampled_array, select_ssa)
from bwtb3m_tpu_torch.index.fm import FMIndex
from bwtb3m_tpu_torch.io import formats
from bwtb3m_tpu_torch.io.inputtypes import parse_input_type
from bwtb3m_tpu_torch.ops import lf as lfops
from bwtb3m_tpu_torch.ops import wavelet_rows as wr
from bwtb3m_tpu_torch.ops.doubling import suffix_array
from bwtb3m_tpu_torch.ops.rank import rank_all_symbols_batch

NSYM, N = 66_000, 70_000
SA_RATE, ISA_RATE = 32, 64
MEM = 1 << 18                      # blocks of 16,384 symbols


def _alphabet(nsym):
    """``nsym`` code points dense from U+0100, surrogates skipped."""
    cps = np.arange(0x100, 0x100 + nsym + 0x800)
    return cps[(cps < 0xD800) | (cps > 0xDFFF)][:nsym]


def _codes(nsym, n, seed):
    """n code points over ``nsym`` distinct ones: uniform, with copies of
    50-2,000-symbol segments of the text itself (repeats, as natural text
    has), then every code point once at a seeded place."""
    rng = np.random.default_rng(seed)
    alphabet = _alphabet(nsym)
    codes = alphabet[rng.integers(0, nsym, n)]
    for _ in range(8):
        ln = int(rng.integers(50, 2000))
        a, b = rng.integers(0, n - ln, 2)
        codes[b:b + ln] = codes[a:a + ln].copy()
    codes[rng.permutation(n)[:nsym]] = alphabet
    assert len(np.unique(codes)) == nsym
    return codes


def _write_utf8(path, codes):
    with open(path, "wb") as f:
        f.write(np.asarray(codes, np.uint32).astype("<u4").tobytes()
                .decode("utf-32-le").encode("utf-8"))
    return str(path)


def _register_samples(bwt_path):
    """Name the .sa / .isa beside a bwtonly=1 build in its .meta, as a
    bwtonly=0 build names its own."""
    base = bwt_path[:-4]
    meta = formats.read_meta(base + ".meta")
    meta["files"]["sa"] = base + ".sa"
    meta["files"]["isa"] = base + ".isa"
    formats.write_meta(base + ".meta", meta)


def _copy_build(src_bwt, dst_bwt, exts=("bwt", "hist", "preisa")):
    for ext in exts:
        shutil.copy(src_bwt[:-4] + "." + ext, dst_bwt[:-4] + "." + ext)
    meta = formats.read_meta(src_bwt[:-4] + ".meta")
    meta["files"] = {k: dst_bwt[:-4] + "." + k for k in exts}
    formats.write_meta(dst_bwt[:-4] + ".meta", meta)
    return dst_bwt


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's files of the 66,000-symbol text, computed once:
    ``engine=doubling bwtonly=1`` (r.bwt, .hist, .preisa), its
    ``compute_ssa`` at rates 32 / 64 (r.sa, r.isa, named in r.meta), the
    full SA of its ``suffix_array`` and its ``check_bwt`` verdict."""
    d = tmp_path_factory.mktemp("alphabet32")
    codes = _codes(NSYM, N, 32)
    inp = _write_utf8(d / "in.txt", codes)
    rbwt = str(d / "r.bwt")
    jax_compute_bwt(JaxOptions(input_path=inp, input_type="utf-8",
                               verbose=0, bwt_only=True,
                               output_filename=rbwt))
    jax_compute_ssa(rbwt, SA_RATE, ISA_RATE)
    _register_samples(rbwt)
    text, sigma = jax_input_type("utf-8").load(inp)
    sa, _isa, _bwt = jax_suffix_array(np.asarray(text), sigma)
    ok = jax_check_bwt(JaxResult.load(rbwt), np.asarray(text))
    port_text, _s = parse_input_type("utf-8").load(inp)
    np.testing.assert_array_equal(port_text, text)
    return {"dir": d, "inp": inp, "rbwt": rbwt, "text": port_text,
            "sa": np.asarray(sa, np.int64), "check": bool(ok)}


def _same_samples(a_bwt, b_bwt):
    for ext in ("sa", "isa"):
        ra, va = load_sampled_array(a_bwt[:-4] + "." + ext)
        rb, vb = load_sampled_array(b_bwt[:-4] + "." + ext)
        assert ra == rb, ext
        np.testing.assert_array_equal(va, vb, err_msg=ext)


@pytest.mark.parametrize("bwt_only", [True, False])
@pytest.mark.parametrize("engine", ["merge", "merge-legacy", "auto"])
def test_merge_builds_equal_reference(ref, tmp_path, engine, bwt_only):
    """``engine=merge``, ``merge-legacy`` and ``auto`` (five blocks) on
    66,000 distinct code points: ``.bwt``, ``.hist`` and ``.preisa`` byte
    for byte the reference's, and with ``bwtonly=0`` the ``.sa`` and
    ``.isa`` values its ``compute_ssa`` gives."""
    out = str(tmp_path / "p.bwt")
    res = compute_bwt(BwtOptions(
        input_path=ref["inp"], input_type="utf-8", device="cpu", verbose=0,
        engine=engine, mem=MEM, bwt_only=bwt_only, output_filename=out,
        sa_sampling_rate=SA_RATE, isa_sampling_rate=ISA_RATE))
    assert res.sigma > 1 << 16
    for ext in ("bwt", "hist", "preisa"):
        assert open(out[:-4] + "." + ext, "rb").read() == \
            open(ref["rbwt"][:-4] + "." + ext, "rb").read(), ext
    if not bwt_only:
        _same_samples(out, ref["rbwt"])


def test_check_bwt_matches_reference(ref, tmp_path, capsys):
    """``check_bwt`` on the reference's ``.bwt``: the reference's verdict
    (True), in process and through ``checkbwt`` (gok=1); a text with one
    symbol changed fails."""
    res = BwtResult.load(ref["rbwt"])
    assert check_bwt(res, ref["text"], device="cpu") is ref["check"] is True
    assert dispatch(["checkbwt", "inputtype=utf-8", "device=cpu",
                     ref["inp"], ref["rbwt"]]) == 0
    assert "gok=1" in capsys.readouterr().out
    bad = ref["text"].copy()
    bad[12345] = bad[12346] if bad[12345] != bad[12346] else bad[0]
    assert bad[12345] != ref["text"][12345]
    assert not check_bwt(res, bad, device="cpu")


def test_ssa_tools_match_reference(ref, tmp_path):
    """On the reference's ``.bwt`` and ``.preisa``: ``compute_ssa`` writes
    the reference's ``.sa`` and ``.isa`` values, ``compute_isa_from_
    preisa`` its ``.isa``, and ``select_ssa`` (the locate walk over the
    ``.sa``) the reference's SA at every rank asked."""
    bwt = _copy_build(ref["rbwt"], str(tmp_path / "p.bwt"))
    compute_ssa(bwt, SA_RATE, ISA_RATE, device="cpu")
    _same_samples(bwt, ref["rbwt"])
    os.remove(bwt[:-4] + ".isa")
    compute_isa_from_preisa(bwt, ISA_RATE, device="cpu")
    _same_samples(bwt, ref["rbwt"])
    _register_samples(bwt)
    ranks = np.r_[0, N - 1, np.random.default_rng(7).integers(0, N, 3000)]
    np.testing.assert_array_equal(select_ssa(bwt, ranks, device="cpu"),
                                  ref["sa"][ranks])


def test_fm_index_matches_reference(ref):
    """``FMIndex`` over the wavelet rows: ``locate_batch`` and ``extract``
    equal the reference's ``FMIndex`` (on a sample: its walks take host
    steps), the SA and the text everywhere else."""
    res = BwtResult.load(ref["rbwt"])
    fm = FMIndex.from_bwt_result(res, device="cpu")
    assert fm.rows.levels == 6 and fm.rows.sigma > 1 << 16
    jfm = JaxFMIndex.from_bwt_result(JaxResult.load(ref["rbwt"]))
    ranks = np.random.default_rng(3).integers(0, N, 4000)
    got = fm.locate_batch(ranks)
    np.testing.assert_array_equal(got, ref["sa"][ranks])
    np.testing.assert_array_equal(got[:48], jfm.locate_batch(ranks[:48]))
    end = 64 * 300
    np.testing.assert_array_equal(fm.extract(end - 8, 8),
                                  jfm.extract(end - 8, 8))
    text = ref["text"]
    for start, length in ((0, 3000), (N - 500, 1200), (17, N)):
        np.testing.assert_array_equal(
            fm.extract(start, length),
            np.take(text, (start + np.arange(length)) % N))


def test_decode_tools_run(ref, tmp_path, capsysbinary):
    """``bwtdecodeblock`` (held to the text by its ``ref=``) and
    ``bwttestdecodespeed`` on the reference's build with its samples."""
    bwt = _copy_build(ref["rbwt"], str(tmp_path / "p.bwt"),
                      ("bwt", "hist", "preisa", "sa", "isa"))
    for low, length in (("100", "4000"), (str(N - 300), "700")):
        assert dispatch(["bwtdecodeblock", "inputtype=utf-8",
                         "ref=" + ref["inp"], "device=cpu", bwt, low,
                         length]) == 0
        assert len(capsysbinary.readouterr().out) == int(length)
    assert dispatch(["bwttestdecodespeed", "steps=32", "maxstreams=64",
                     "device=cpu", bwt]) == 0
    assert capsysbinary.readouterr().err.decode().count("LF-steps/s") == 3


# ------------------------------------------------------------ 7 levels

N7, NSYM7 = 300_000, 270_000


@pytest.fixture(scope="module")
def seven(tmp_path_factory):
    """300,000 code points over 270,000 distinct ones, its port
    ``engine=doubling`` build and the wavelet rows of its BWT."""
    d = tmp_path_factory.mktemp("alphabet32_7")
    codes = _codes(NSYM7, N7, 7)
    inp = _write_utf8(d / "in.txt", codes)
    out = str(d / "d.bwt")
    res = compute_bwt(BwtOptions(input_path=inp, input_type="utf-8",
                                 device="cpu", verbose=0, bwt_only=True,
                                 output_filename=out))
    wm, symmap = res.load_wavelet("cpu")
    bwt = np.asarray(res.load_bwt())
    dense = np.searchsorted(symmap, bwt)
    return {"dir": d, "inp": inp, "bwt": out, "wm": wm, "dense": dense}


def test_seven_level_rows_match_numpy(seven):
    """rank, access, LF, ``rank_all_symbols_batch`` and
    ``backward_search_step`` over 7-level rows against a numpy oracle
    (sorted (symbol, position) keys)."""
    wm, dense = seven["wm"], seven["dense"]
    n, sigma = len(dense), wm.sigma
    assert wm.levels == wr.MAX_LEVELS == 7 and sigma > 1 << 18
    C = np.r_[0, np.cumsum(np.bincount(dense, minlength=sigma))]
    keys = np.sort(dense.astype(np.int64) * (n + 1) + np.arange(n))

    def oracle(c, i):
        return np.searchsorted(keys, c * (n + 1) + i) - C[c]

    rng = np.random.default_rng(1)
    i = np.r_[0, n, 95, 96, 97, rng.integers(0, n + 1, 20000)]
    c = np.r_[dense[:5], rng.integers(0, sigma, 20000)]
    np.testing.assert_array_equal(
        wr.rank(wm, torch.from_numpy(c), torch.from_numpy(i)).numpy(),
        oracle(c, i))
    p = rng.integers(0, n, 20000)
    np.testing.assert_array_equal(wr.access(wm, torch.from_numpy(p)).numpy(),
                                  dense[p])
    sym, lf = wr.lf_step(wm, torch.from_numpy(p))
    np.testing.assert_array_equal(lf.numpy(),
                                  C[dense[p]] + oracle(dense[p], p))
    pos = np.r_[0, n, rng.integers(0, n + 1, 6)]
    got = rank_all_symbols_batch(wm, torch.from_numpy(pos)).numpy()
    for j, q in enumerate(pos):
        np.testing.assert_array_equal(
            got[j], np.bincount(dense[:q], minlength=sigma))
    lo, hi = rng.integers(0, n + 1, (2, 5000))
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    c = rng.integers(0, sigma, 5000)
    l2, h2 = lfops.backward_search_step(wm, torch.from_numpy(c),
                                        torch.from_numpy(lo),
                                        torch.from_numpy(hi))
    np.testing.assert_array_equal(l2.numpy(), C[c] + oracle(c, lo))
    np.testing.assert_array_equal(h2.numpy(), C[c] + oracle(c, hi))


def test_seven_level_merge_build_equals_doubling(seven, tmp_path):
    """``engine=merge`` (five blocks of 65,536 symbols, 7-level rows under
    the chains) against the port's ``engine=doubling``, byte for byte,
    and ``check_bwt`` of it."""
    out = str(tmp_path / "m.bwt")
    res = compute_bwt(BwtOptions(input_path=seven["inp"], input_type="utf-8",
                                 device="cpu", verbose=0, engine="merge",
                                 mem=1 << 20, bwt_only=True,
                                 output_filename=out))
    for ext in ("bwt", "hist", "preisa"):
        assert open(out[:-4] + "." + ext, "rb").read() == \
            open(seven["bwt"][:-4] + "." + ext, "rb").read(), ext
    text, _s = parse_input_type("utf-8").load(seven["inp"])
    assert check_bwt(res, text, device="cpu")


def test_limits_name_themselves():
    """Past 2^21 dense symbols the rows and the merge engine refuse, and
    past 256 symbols a text of 2^31 symbols, naming the limit."""
    with pytest.raises(ValueError, match="2097152"):
        wr.build_wavelet(torch.zeros(4, dtype=torch.int32), (1 << 21) + 1)
    with pytest.raises(ValueError, match="2,097,152"):
        ms.blockwise_bwt_scaled(np.zeros(4, np.uint32), (1 << 21) + 1,
                                BwtOptions(input_path="x"), device="cpu")
    huge = np.broadcast_to(np.uint32(0), (1 << 31,))
    with pytest.raises(ValueError, match="2\\^31"):
        ms.blockwise_bwt_scaled(huge, 70000, BwtOptions(input_path="x"),
                                device="cpu")


@pytest.mark.slow
def test_merge_legacy_equals_reference_legacy_engine(ref, tmp_path):
    """The reference's own ``engine=merge-legacy`` (its legacy full-SA
    engine, about two minutes at this size) against the port's, every
    file but ``.meta`` and ``.hwt``."""
    opts = dict(input_path=ref["inp"], input_type="utf-8", verbose=0,
                engine="merge-legacy", mem=MEM, bwt_only=False,
                sa_sampling_rate=SA_RATE, isa_sampling_rate=ISA_RATE)
    jax_compute_bwt(JaxOptions(output_filename=str(tmp_path / "r.bwt"),
                               **opts))
    compute_bwt(BwtOptions(output_filename=str(tmp_path / "p.bwt"),
                           device="cpu", **opts))
    for ext in ("bwt", "hist", "preisa", "sa", "isa"):
        assert (tmp_path / ("p." + ext)).read_bytes() == \
            (tmp_path / ("r." + ext)).read_bytes(), ext
