"""The walks past 256 symbols against the reference's legacy rank path.

The reference walks alphabets of more than 256 symbols over its
``OccTable`` (``ops/lf.py::lf_walk``, ``engine/verify.py::
_check_bwt_legacy`` with ``_walk_verify_run``, ``engine/ssa.py::
_harvest_walk``); the port walks the wavelet rows of
``ops/wavelet_rows.py`` (on the card: ``bwt_lf_walk_wm``; here the plain
versions).  On UTF-8 texts of a few hundred and a few thousand code
points: the final ranks of ``lf_walk``, ``check_bwt`` true and false (one
symbol changed) with the same ``.preisa.checkinfo`` bytes, the ``.sa``
and ``.isa`` bytes of ``compute_ssa`` and ``compute_isa_from_preisa`` at
several rates, and ``bwttestdecodespeed``.  The gates: texts of 2^31
symbols or more raise ``ValueError`` on these paths, ``compute_sa_device``
raises the reference's ``ValueError``, and so does ``select_ssa`` without
a sampled ``.sa``; with one it answers the reference's SA values through
the FM index's locate walk.  Exact equality.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.engine.result import BwtResult as JaxResult
from bwtb3m_tpu.engine.ssa import compute_isa_from_preisa as jax_isa
from bwtb3m_tpu.engine.ssa import compute_ssa as jax_ssa
from bwtb3m_tpu.engine.verify import _check_bwt_legacy
from bwtb3m_tpu.io import formats as jformats
from bwtb3m_tpu.io.inputtypes import parse_input_type as jax_input_type
from bwtb3m_tpu.ops.lf import lf_walk as jax_lf_walk
from bwtb3m_tpu.util.log import VerboseLog as JaxLog
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import (BwtResult, check_bwt,
                                     compute_isa_from_preisa,
                                     compute_sa_device, compute_ssa,
                                     select_ssa)
from bwtb3m_tpu_torch.engine.result import clear_caches
from bwtb3m_tpu_torch.io.inputtypes import parse_input_type
from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops.wavelet_rows import wavelet_from_jax


def _utf8(path, nsym, n, seed, base=0x4e00):
    rng = np.random.default_rng(seed)
    codes = (base + rng.integers(0, nsym, n)).astype(np.uint32)
    codes[:50] = ord("a") + np.arange(50) % 26       # ASCII among them
    with open(path, "wb") as f:
        f.write(codes.astype("<u4").tobytes().decode("utf-32-le")
                .encode("utf-8"))
    return path


@pytest.fixture(scope="module", params=[(400, 6000), (3000, 9000)],
                ids=["sigma400", "sigma3000"])
def build(request, tmp_path_factory):
    """A reference doubling build of a UTF-8 text (sigma > 256)."""
    nsym, n = request.param
    d = tmp_path_factory.mktemp("legacy")
    inp = _utf8(str(d / "u.txt"), nsym, n, nsym)
    res = jax_compute_bwt(JaxOptions(input_path=inp, input_type="utf-8",
                                     verbose=0, preisa_sampling_rate=64))
    assert res.sigma > 256
    text, _s = jax_input_type("utf-8").load(inp)
    return inp, res.bwt_path, text


def _copy(src_bwt, dst_dir):
    """The build's files under another base (the tools write beside
    the .bwt)."""
    base = src_bwt[:-4]
    meta = json.load(open(base + ".meta"))
    out = os.path.join(dst_dir, "c")
    files = {}
    for k in ("bwt", "hist", "preisa"):
        shutil.copy(base + "." + k, out + "." + k)
        files[k] = out + "." + k
    meta["files"] = files
    with open(out + ".meta", "w") as f:
        json.dump(meta, f)
    return out + ".bwt"


def test_text_loads_equal(build):
    inp, _bwt, text = build
    port, _s = parse_input_type("utf-8").load(inp)
    np.testing.assert_array_equal(port, text)
    assert port.dtype == text.dtype


@pytest.mark.parametrize("steps", [1, 97, 1000])
def test_lf_walk_final_rank(build, steps):
    _inp, bwt_path, _text = build
    occ, symmap = JaxResult.load(bwt_path).load_occ(dense=True)
    wm = wavelet_from_jax(occ, symmap)
    rng = np.random.default_rng(steps)
    r0 = rng.integers(0, int(occ.n), 300).astype(np.int32)
    want, _ = jax_lf_walk(occ, jnp.asarray(r0), steps)
    got = lw.lf_walk(wm, torch.from_numpy(r0).long(), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_bwt_true_with_checkinfo(build, tmp_path):
    _inp, bwt_path, text = build
    ref = _copy(bwt_path, str(tmp_path))
    assert _check_bwt_legacy(JaxResult.load(ref), text, JaxLog(0), len(text))
    want = open(ref[:-4] + ".preisa.checkinfo", "rb").read()
    os.remove(ref[:-4] + ".preisa.checkinfo")
    clear_caches()
    assert check_bwt(BwtResult.load(ref), text, device="cpu")
    assert open(ref[:-4] + ".preisa.checkinfo", "rb").read() == want


@pytest.mark.parametrize("where", ["text", "bwt"])
def test_check_bwt_false_on_one_symbol_changed(build, tmp_path, where):
    _inp, bwt_path, text = build
    ref = _copy(bwt_path, str(tmp_path))
    res = BwtResult.load(ref)
    if where == "text":
        text = text.copy()
        i = len(text) // 3
        text[i] = text[i + 1] if text[i] != text[i + 1] else text[i + 2]
    else:
        from bwtb3m_tpu_torch.engine.result import write_bwt
        bwt = res.load_bwt()
        i = len(bwt) // 2
        bwt[i] = bwt[i + 1] if bwt[i] != bwt[i + 1] else bwt[i + 3]
        write_bwt(ref, bwt, res.sigma)
    want = _check_bwt_legacy(JaxResult.load(ref), text, JaxLog(0), len(text))
    clear_caches()
    assert want is False
    assert check_bwt(BwtResult.load(ref), text, device="cpu") is False


def test_check_bwt_text_symbol_not_in_bwt(build, tmp_path):
    _inp, bwt_path, text = build
    text = text.copy()
    text[5] = 0x10FFFF
    ref = _copy(bwt_path, str(tmp_path))
    assert not _check_bwt_legacy(JaxResult.load(ref), text, JaxLog(0),
                                 len(text))
    assert not check_bwt(BwtResult.load(ref), text, device="cpu")


@pytest.mark.parametrize("sarate,isarate", [(1, 1), (8, 16), (32, 64),
                                            (5, 7)])
def test_compute_ssa_bytes(build, tmp_path, sarate, isarate):
    _inp, bwt_path, _text = build
    os.makedirs(tmp_path / "ref")
    ref = _copy(bwt_path, str(tmp_path / "ref"))
    port = _copy(bwt_path, str(tmp_path))
    jax_ssa(ref, sarate, isarate, log=JaxLog(0))
    clear_caches()
    compute_ssa(port, sarate, isarate, log=None, device="cpu")
    for ext in ("sa", "isa"):
        assert open(ref[:-4] + "." + ext, "rb").read() == \
            open(port[:-4] + "." + ext, "rb").read(), ext


@pytest.mark.parametrize("isarate", [1, 64, 1000])
def test_compute_isa_from_preisa_bytes(build, tmp_path, isarate):
    _inp, bwt_path, _text = build
    os.makedirs(tmp_path / "ref")
    ref = _copy(bwt_path, str(tmp_path / "ref"))
    port = _copy(bwt_path, str(tmp_path))
    jax_isa(ref, isarate, log=JaxLog(0))
    clear_caches()
    compute_isa_from_preisa(port, isarate, device="cpu")
    assert open(ref[:-4] + ".isa", "rb").read() == \
        open(port[:-4] + ".isa", "rb").read()


def test_bwttestdecodespeed_runs(build, capsys):
    _inp, bwt_path, _text = build
    assert dispatch(["bwttestdecodespeed", "steps=32", "maxstreams=64",
                     "device=cpu", bwt_path]) == 0
    err = capsys.readouterr().err
    assert err.count("LF-steps/s") == 3          # 1, 8 and 64 streams


def _fake(tmp_path, n, sigma):
    base = str(tmp_path / ("f%d" % sigma))
    files = {"bwt": base + ".bwt", "preisa": base + ".preisa"}
    with open(base + ".meta", "w") as f:
        json.dump({"format": "bwtb3m_tpu/v1", "n": n, "sigma": sigma,
                   "files": files}, f)
    open(base + ".bwt", "wb").close()
    return base + ".bwt"


def test_paths_past_256_symbols_stop_at_2_31(tmp_path):
    """The reference's legacy lanes are int32: past 256 symbols the port
    raises ValueError from n = 2^31 on, before reading any file."""
    path = _fake(tmp_path, 1 << 31, 300)
    res = BwtResult.load(path)
    text = np.broadcast_to(np.int8(1), (1 << 31,))
    with pytest.raises(ValueError, match="2\\^31"):
        check_bwt(res, text, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        compute_ssa(path, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        compute_isa_from_preisa(path, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        res.load_wavelet("cpu")


def test_compute_sa_device_raises_value_error_past_256(build):
    """The reference raises ValueError("compute_sa_device needs n < 2^31,
    sigma <= 256"); so does the port (it raised NotImplementedError)."""
    _inp, bwt_path, _text = build
    from bwtb3m_tpu.engine.ssa import compute_sa_device as jax_sa_device
    with pytest.raises(ValueError, match="sigma <= 256"):
        jax_sa_device(bwt_path)
    with pytest.raises(ValueError, match="sigma <= 256"):
        compute_sa_device(bwt_path, device="cpu")


def test_select_ssa_past_256_without_sa_raises_value_error(build, tmp_path):
    """No sampled .sa: ValueError in both packages.  With one both answer
    through FMIndex.locate_batch (the port: the locate walk over the
    wavelet rows): the same SA values, those of the .sa where it samples
    them."""
    _inp, bwt_path, _text = build
    from bwtb3m_tpu.engine.ssa import select_ssa as jax_select
    ref = _copy(bwt_path, str(tmp_path))
    ranks = np.arange(3, dtype=np.int64)
    with pytest.raises(ValueError, match="needs a sampled .sa"):
        jax_select(ref, ranks)
    with pytest.raises(ValueError, match="needs a sampled .sa"):
        select_ssa(ref, ranks, device="cpu")
    res = JaxResult.load(bwt_path)
    rate, sa = jformats.read_sampled_array(res.sa_path)
    rng = np.random.default_rng(res.n)
    ranks = np.concatenate([[0, res.n - 1], rng.integers(0, res.n, 300),
                            rate * rng.integers(0, len(sa), 50)])
    got = select_ssa(bwt_path, ranks, device="cpu")
    np.testing.assert_array_equal(got, jax_select(bwt_path, ranks))
    np.testing.assert_array_equal(got[-50:], sa[ranks[-50:] // rate])
    assert lw.lf_walk.launches == 0
