"""The RLH1 codec of the port against the reference's.

``bwtb3m_tpu_torch/io/rlh.py`` is the port's copy of
``bwtb3m_tpu/io/rlh.py`` with the native run decoder
(``native.rlh_decode_runs``).  For seeded BWT-like symbol runs the
encoder writes the reference's bytes; a file written by either package
loads in the other (``decode_all``, ``rank``, ``symbol_histogram``);
``compute_bwt(bwt_codec="rlh")`` with the doubling and the merge engine
writes the reference's ``.bwt`` (and ``.hist``, ``.preisa``), and
``checkbwt`` / ``bwtcomputessa`` read an RLH1 ``.bwt``.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
import torch

torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt)

PKGS = ("bwtb3m_tpu", "bwtb3m_tpu_torch")       # reference, port


def both(mod):
    return [importlib.import_module("%s.%s" % (p, mod)) for p in PKGS]


def _runs(sigma, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, sigma, max(1, n // 5))
    lens = rng.geometric(0.2, len(vals))
    return np.repeat(vals, lens)[:n].astype(np.int32)


@pytest.mark.parametrize("sigma,n,block", [
    (4, 20000, 4096), (200, 7000, 333), (300, 5000, 1000),
    (5000, 9000, 65536), (2, 1, 64), (4, 0, 64)])
def test_rlh_encode_byte_identical_and_cross_loads(tmp_path, sigma, n,
                                                   block):
    ref, port = both("io.rlh")
    sym = _runs(sigma, n, sigma + n)
    a, b = str(tmp_path / "a.bwt"), str(tmp_path / "b.bwt")
    ref.rlh_encode(a, sym, sigma=sigma, block_size=block)
    port.rlh_encode(b, sym, sigma=sigma, block_size=block)
    assert open(a, "rb").read() == open(b, "rb").read()
    for reader_mod, path in ((ref, b), (port, a)):   # each reads the other's
        with reader_mod.RLHReader(path) as r:
            np.testing.assert_array_equal(r.decode_all(), sym)
            np.testing.assert_array_equal(
                r.symbol_histogram().astype(np.int64),
                np.bincount(sym, minlength=sigma)[:sigma])
            for c in (0, sigma - 1):
                for i in (0, 1, block, block + 1, n // 2, n):
                    assert r.rank(c, i) == int(np.count_nonzero(
                        sym[:i] == c))


def test_open_bwt_dispatches_rlh(tmp_path):
    _ref, port = both("io.rl")
    _r, prlh = both("io.rlh")
    sym = _runs(7, 3000, 1)
    p = str(tmp_path / "x.bwt")
    prlh.rlh_encode(p, sym, sigma=7)
    with port.open_bwt(p) as r:
        assert isinstance(r, prlh.RLHReader)
        np.testing.assert_array_equal(r.decode_all(), sym)


def test_native_rlh_decode_runs_equal(tmp_path):
    """The port's native run decoder gives the reference's runs, and the
    Python fallback gives the same symbols."""
    ref_rlh, port_rlh = both("io.rlh")
    _rn, pn = both("native")
    sym = _runs(300, 20000, 9)
    p = str(tmp_path / "x.bwt")
    port_rlh.rlh_encode(p, sym, sigma=300, block_size=5000)
    with port_rlh.RLHReader(p) as r:
        for b in range(r.nb):
            got = r._read_block_runs(b)
            with ref_rlh.RLHReader(p) as q:
                want = q._read_block_runs(b)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        assert pn.get_lib() is not None
        lib, pn._lib = pn._lib, None
        tried, pn._tried = pn._tried, True
        try:
            np.testing.assert_array_equal(r.decode_all(), sym)
        finally:
            pn._lib, pn._tried = lib, tried


def _dna(path, n=6000, seed=2):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())
    return path


def _utf8(path, nsym=300, n=5000, seed=3):
    rng = np.random.default_rng(seed)
    codes = (0x3b1 + rng.integers(0, nsym, n)).astype(np.uint32)
    with open(path, "wb") as f:
        f.write(codes.astype("<u4").tobytes().decode("utf-32-le")
                .encode("utf-8"))
    return path


@pytest.mark.parametrize("engine", ["doubling", "merge"])
@pytest.mark.parametrize("kind", ["dna", "utf8"])
def test_compute_bwt_rlh_equals_reference(tmp_path, engine, kind):
    """bwtcodec=rlh: the .bwt, .hist and .preisa bytes of both engines
    are the reference's (whose merge takes its legacy engine past 256
    distinct symbols), and the port's checkbwt accepts the RLH1 file."""
    inp = (_dna if kind == "dna" else _utf8)(str(tmp_path / "in"))
    itype = "bytestream" if kind == "dna" else "utf-8"
    kw = dict(input_type=itype, verbose=0, bwt_codec="rlh", engine=engine,
              mem=16384, bwt_only=True)
    jax_compute_bwt(JaxOptions(input_path=inp,
                               output_filename=str(tmp_path / "r.bwt"), **kw))
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu",
                                 output_filename=str(tmp_path / "p.bwt"),
                                 **kw))
    for ext in ("bwt", "hist", "preisa"):
        assert (open(str(tmp_path / ("r." + ext)), "rb").read()
                == open(str(tmp_path / ("p." + ext)), "rb").read()), ext
    assert open(res.bwt_path, "rb").read(4) == b"RLH1"
    from bwtb3m_tpu_torch.io.inputtypes import parse_input_type
    text, _s = parse_input_type(itype).load(inp)
    assert check_bwt(BwtResult.load(res.bwt_path), text, device="cpu")


def test_checkbwt_and_ssa_tools_on_an_rlh_file(tmp_path):
    """The CLI tools on an RLH1 .bwt written by the reference."""
    inp = _dna(str(tmp_path / "in"), n=5000)
    jax_compute_bwt(JaxOptions(input_path=inp, verbose=0, bwt_codec="rlh",
                               output_filename=str(tmp_path / "r.bwt")))
    bwt = str(tmp_path / "r.bwt")
    assert open(bwt, "rb").read(4) == b"RLH1"
    ref_sa = open(str(tmp_path / "r.sa"), "rb").read()
    ref_isa = open(str(tmp_path / "r.isa"), "rb").read()
    assert dispatch(["checkbwt", "device=cpu", "verbose=0", inp, bwt]) == 0
    assert dispatch(["bwtcomputessa", "device=cpu", "verbose=0",
                     "sasamplingrate=32", "isasamplingrate=262144",
                     bwt]) == 0
    assert open(str(tmp_path / "r.sa"), "rb").read() == ref_sa
    assert open(str(tmp_path / "r.isa"), "rb").read() == ref_isa
