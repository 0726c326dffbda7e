"""``engine=merge-legacy`` and ``BWTB3M_SORT=ls``, mapped onto the port.

The reference sends ``engine=merge-legacy`` to its round-1 engine (full
SA and ISA per block, no alphabet compaction); the port runs its scaled
merge engine.  On DNA, a periodic text, poly-A, bytes over 200 symbols
and UTF-8 over 300 and 5,000 code points, with ``bwtonly=1`` and ``=0``,
the port's ``.bwt .hist .preisa`` (and ``.sa .isa .hwt``) are the
reference's byte for byte and the ``.meta`` differs only in the names of
the files.  Texts whose rotations come in equal copies (powers of a
shorter string) get their samples at every rate, from a root of at
most ``max_block_symbols``.  Past 65,536 distinct
symbols the port raises naming ROADMAP.md item 11
(``tests/test_torch_guards.py``).

``BWTB3M_SORT=ls`` selects the reference's tie-compacted doubling; the
port runs its one doubling sort, whose SA, ranks and BWT equal the
reference's under ``ls`` on five texts.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.ops.doubling import suffix_array


def _utf8(rng, nsym, n, base):
    cps = rng.integers(base, base + nsym, n)
    cps[:nsym] = base + np.arange(nsym)
    rng.shuffle(cps)
    return "".join(map(chr, cps)).encode()


def _texts():
    rng = np.random.default_rng(11)
    dna = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    dna[3000:3400] = dna[1000:1400]                 # a repeat
    return {
        "dna": (dna.tobytes(), "bytestream"),
        "periodic": ((b"ACGTTG" * 600)[:3001], "bytestream"),
        "poly-A": (b"A" * 2000, "bytestream"),
        "bytes200": (rng.integers(30, 231, 5000).astype(np.uint8).tobytes(),
                     "bytestream"),
        "utf8-300": (_utf8(rng, 300, 4000, 0x100), "utf-8"),
        "utf8-5000": (_utf8(rng, 5000, 6000, 0x4E00), "utf-8"),
    }


TEXTS = _texts()


def _build_both(tmp_path, data, itype, mem=8192, **kw):
    inp = tmp_path / "t.in"
    inp.write_bytes(data)
    outs = {}
    for name, run, opts, extra in (
            ("port", compute_bwt, BwtOptions, {"device": "cpu"}),
            ("ref", jax_compute_bwt, JaxOptions, {})):
        out = str(tmp_path / ("%s.bwt" % name))
        run(opts(input_path=str(inp), input_type=itype, engine="merge-legacy",
                 mem=mem, verbose=0, output_filename=out, **kw, **extra))
        outs[name] = out[:-4]
    return outs


def _assert_same_files(outs, exts):
    for ext in exts:
        with open(outs["port"] + ext, "rb") as a, \
                open(outs["ref"] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    metas = {k: json.load(open(v + ".meta")) for k, v in outs.items()}
    files = {k: m.pop("files") for k, m in metas.items()}
    assert metas["port"] == metas["ref"]
    assert sorted(files["port"]) == sorted(files["ref"])


@pytest.mark.parametrize("bwtonly", [1, 0])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_merge_legacy_writes_the_reference_files(tmp_path, name, bwtonly):
    data, itype = TEXTS[name]
    outs = _build_both(tmp_path, data, itype, bwt_only=bool(bwtonly))
    exts = (".bwt", ".hist", ".preisa")
    if not bwtonly:
        exts += (".sa", ".isa", ".hwt")
    _assert_same_files(outs, exts)


@pytest.mark.parametrize("data,rate", [
    pytest.param(b"AA", 1, id="AA"), pytest.param(b"ACAC", 1, id="ACAC"),
    pytest.param(b"ACGTTG" * 4, 1, id="ACGTTG^4"),
    pytest.param(b"ACGTTG" * 300, 7, id="ACGTTG^300"),
    pytest.param(b"A" * 700, 32, id="A^700")])
def test_merge_legacy_equal_rotations(tmp_path, data, rate):
    """Equal rotations lie in position order in the legacy engine's .sa;
    the port writes them from the sort of the text's root."""
    outs = _build_both(tmp_path, data, "bytestream", mem=1024,
                       bwt_only=False, sa_sampling_rate=rate,
                       isa_sampling_rate=rate)
    _assert_same_files(outs, (".bwt", ".hist", ".preisa", ".sa", ".isa",
                              ".hwt"))


ROOT = np.random.default_rng(3).choice(np.frombuffer(b"ACGT", np.uint8),
                                       1500).tobytes()


@pytest.mark.parametrize("bwtonly", [0, 1])
def test_merge_legacy_root_past_one_block(tmp_path, bwtonly):
    """A power text's samples come from a single-block sort of its root:
    a root past max_block_symbols raises before the build with
    bwtonly=0 (ROADMAP.md Queue 3); bwtonly=1 sorts no root and writes
    the reference's files."""
    kw = {"max_block_symbols": 1024, "bwt_only": bool(bwtonly)}
    if not bwtonly:
        inp = tmp_path / "t.in"
        inp.write_bytes(ROOT * 2)
        with pytest.raises(NotImplementedError, match="Queue 3"):
            compute_bwt(BwtOptions(
                input_path=str(inp), input_type="bytestream",
                engine="merge-legacy", mem=8192, verbose=0, device="cpu",
                output_filename=str(tmp_path / "port.bwt"), **kw))
        assert not (tmp_path / "port.bwt").exists()
        return
    outs = _build_both(tmp_path, ROOT * 2, "bytestream", **kw)
    _assert_same_files(outs, (".bwt", ".hist", ".preisa"))


def _sort_texts():
    rng = np.random.default_rng(5)
    block = rng.integers(0, 4, 97)
    return {
        "dna": (rng.integers(0, 4, 5000), 4),
        "period-4": (np.tile([0, 1, 2, 3], 1250), 4),
        "poly-A": (np.zeros(3000, np.int64), 4),
        "30 copies of 97": (np.tile(block, 30), 4),
        "bytes200": (rng.integers(0, 200, 5000), 200),
    }


SORT_TEXTS = _sort_texts()


@pytest.mark.parametrize("name", sorted(SORT_TEXTS))
def test_sort_ls_equals_reference(monkeypatch, name):
    text, sigma = SORT_TEXTS[name]
    monkeypatch.setenv("BWTB3M_SORT", "ls")
    want = jax_suffix_array(text.astype(np.int32), sigma)
    got = suffix_array(text.astype(np.int32), sigma, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
