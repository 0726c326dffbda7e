"""The merge engine past 256 distinct symbols against the reference.

The reference sends ``engine=merge`` on an alphabet of more than 256
distinct symbols to its legacy full-SA engine (``engine/merge.py::
blockwise_bwt``); the port runs its scaled engine on dense uint16 ids:
16-bit regions, window sorts over 16-bit symbols, the native
comparator's uint16 form for the gt bits, and wavelet rank rows under
the gap chains (on the card ``bwt_gap_chain_mk_wm``; here the plain
version), pair by pair and without checkpoints.  On UTF-8 texts of about
300 and 3,000 distinct code points in small blocks (``mem=16K``: blocks of
1,024 symbols), on periodic texts and on a text of exactly 257 distinct
symbols, the ``.bwt``, ``.hist``, ``.preisa``, ``.sa``, ``.isa`` (and
``.hwt``, whose port builds level by level) bytes equal the
reference's, and ``.meta`` differs only in the file names it records.  ``<output>.stop`` stops the build; no checkpoint is written.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt)
from bwtb3m_tpu_torch.engine import merge_scaled as ms
from bwtb3m_tpu_torch.io.inputtypes import parse_input_type
from bwtb3m_tpu_torch.ops import gapbatch as gb


def _write_utf8(path, codes):
    with open(path, "wb") as f:
        f.write(np.asarray(codes, np.uint32).astype("<u4").tobytes()
                .decode("utf-32-le").encode("utf-8"))
    return path


def _corpus(nsym, n, seed):
    """Zipf-weighted code points from Latin, Greek, Cyrillic and CJK,
    with copies of earlier segments (repeats as in natural text)."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(0x20, 0x7f), np.arange(0xc0, 0x17f),
                           np.arange(0x391, 0x3c9), np.arange(0x410, 0x44f),
                           np.arange(0x4e00, 0x4e00 + 8000)])
    alphabet = pool[:nsym]
    p = 1.0 / np.arange(1, nsym + 1)
    codes = alphabet[rng.choice(nsym, n, p=p / p.sum())]
    codes[:nsym] = alphabet                     # every symbol present
    for _ in range(6):
        ln = int(rng.integers(40, 300))
        a, b = rng.integers(nsym, n - ln, 2)
        codes[b:b + ln] = codes[a:a + ln]
    return codes


def _both(tmp_path, codes, bwt_only=False, mem=16384, **kw):
    inp = _write_utf8(str(tmp_path / "in.txt"), codes)
    opts = dict(input_type="utf-8", verbose=0, engine="merge", mem=mem,
                bwt_only=bwt_only, **kw)
    jax_compute_bwt(JaxOptions(input_path=inp,
                               output_filename=str(tmp_path / "r.bwt"),
                               **opts))
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu",
                                 output_filename=str(tmp_path / "p.bwt"),
                                 **opts))
    return inp, res


def _same_files(tmp_path, exts):
    for ext in exts:
        a = open(str(tmp_path / ("r." + ext)), "rb").read()
        b = open(str(tmp_path / ("p." + ext)), "rb").read()
        assert a == b, ext
    ma = json.load(open(str(tmp_path / "r.meta")))
    mb = json.load(open(str(tmp_path / "p.meta")))
    ma.pop("files"), mb.pop("files")
    assert ma == mb


@pytest.mark.parametrize("nsym,n", [(300, 5000), (3000, 7000)])
def test_merge_equals_reference(tmp_path, nsym, n):
    gb.reset_launch_counts()
    inp, res = _both(tmp_path, _corpus(nsym, n, nsym))
    assert res.sigma > 256
    _same_files(tmp_path, ("bwt", "hist", "preisa", "sa", "isa", "hwt"))
    text, _s = parse_input_type("utf-8").load(inp)
    assert check_bwt(BwtResult.load(res.bwt_path), text, device="cpu")
    assert not any(f.startswith("p.bwt_tmp") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("mode", ["plain", "hostmem", "force_wide"])
def test_exactly_257_distinct_symbols(tmp_path, monkeypatch, mode):
    """257 distinct symbols: one past the byte compaction, 9 levels; with
    ``hostmem=`` the dense uint16 ids go to a memory-mapped spill; under
    ``BWTB3M_FORCE_WIDE`` the merges stay narrow (texts past 256 symbols
    stay below 2^31), as the reference's legacy engine."""
    if mode == "force_wide":
        monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    codes = _corpus(257, 4000, 257)
    _both(tmp_path, codes, bwt_only=True,
          host_mem=1000 if mode == "hostmem" else None)
    _same_files(tmp_path, ("bwt", "hist", "preisa"))


@pytest.mark.parametrize("period,copies", [(1, 0), (3, 0), (300, 6),
                                           (1031, 2)])
def test_periodic_texts(tmp_path, period, copies):
    """Periodic texts: equal rotations keep position order (the window
    sorts' tie groups and the anchors' long lookbacks).  A period of 300
    or more holds every symbol and the text is ``copies`` whole periods
    (every rotation equals ``copies - 1`` others); a shorter period
    follows the 300 symbols once, as a 1,500-symbol periodic tail."""
    rng = np.random.default_rng(period)
    alphabet = 0x4e00 + rng.permutation(300)
    if copies:
        unit = np.concatenate([alphabet, rng.choice(alphabet,
                                                    period - 300)])
        codes = np.tile(unit, copies)
    else:
        codes = np.concatenate([alphabet, np.tile(alphabet[:period],
                                                  1500 // period)])
    _both(tmp_path, codes, bwt_only=True)
    _same_files(tmp_path, ("bwt", "hist", "preisa"))


def test_stop_file_stops_and_no_checkpoint(tmp_path):
    inp = _write_utf8(str(tmp_path / "in.txt"), _corpus(300, 5000, 1))
    out = str(tmp_path / "p.bwt")
    open(out + ".stop", "w").close()
    with pytest.raises(RuntimeError, match="stop requested"):
        compute_bwt(BwtOptions(input_path=inp, input_type="utf-8",
                               device="cpu", verbose=0, engine="merge",
                               mem=16384, bwt_only=True,
                               output_filename=out))
    assert not [f for f in os.listdir(tmp_path) if "BWTREG" in f]


def test_engine_gates(tmp_path):
    """More than 65,536 distinct symbols (which raised NotImplementedError
    naming ROADMAP.md item 11 before the 32-bit symbol forms) build
    through ``engine=merge`` the reference's ``engine=doubling`` files;
    past 2^21 dense symbols the engine refuses; a level of merges past 256
    symbols runs pair by pair."""
    codes = 0x10000 + np.arange(70000)
    inp = _write_utf8(str(tmp_path / "in.txt"), codes)
    res = compute_bwt(BwtOptions(input_path=inp, input_type="utf-8",
                                 device="cpu", verbose=0, engine="merge",
                                 bwt_only=True, mem=1 << 19,
                                 output_filename=str(tmp_path / "p.bwt")))
    jax_compute_bwt(JaxOptions(input_path=inp, input_type="utf-8",
                               verbose=0, bwt_only=True,
                               output_filename=str(tmp_path / "r.bwt")))
    assert res.sigma > 1 << 16
    for ext in ("bwt", "hist", "preisa"):
        assert open(str(tmp_path / ("r." + ext)), "rb").read() == \
            open(str(tmp_path / ("p." + ext)), "rb").read(), ext

    class Ctx:
        sigma = 300

    left = ms.Region(0, 1024, None, None, None, None, 0, None)
    right = ms.Region(1024, 2048, None, None, None, None, 0, None)
    tail = ms.Region(2048, 3072, None, None, None, None, 0, None)
    far = ms.Region(3072, 4096, None, None, None, None, 0, None)
    assert not ms._level_fits_batched(Ctx(), [(left, right), (tail, far)])
    with pytest.raises(ValueError, match="2,097,152"):
        ms.blockwise_bwt_scaled(np.zeros(10, np.uint32), (1 << 21) + 1,
                                BwtOptions(input_path="x"), device="cpu")
