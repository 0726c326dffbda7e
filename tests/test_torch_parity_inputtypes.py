"""The cases of ``tests/test_inputtypes_e2e.py``, the port against the
reference: a build over every input type (compactstream, lz4, utf-8,
pac, and a compact made by ``digitsToCompact``) writes the reference's
files byte for byte (the port on the CPU), its BWT is the naive one and
the port's ``check_bwt`` passes.  The inputs are written by the port's
writers and must be byte for byte the reference's."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu.io import compact as jax_compact
from bwtb3m_tpu.io.lz4io import write_lz4_stream as jax_write_lz4_stream
from bwtb3m_tpu.io.pac import write_pac as jax_write_pac
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import check_bwt
from bwtb3m_tpu_torch.io import compact
from bwtb3m_tpu_torch.io.lz4io import write_lz4_stream
from bwtb3m_tpu_torch.io.pac import write_pac
from oracle import naive_bwt, random_string
from test_torch_hostlayer import _reference_library
from torch_parity import BWT_EXTS, SAMPLE_EXTS, assert_same_files, build_both


def _same_input(tmp_path, name, write, jax_write):
    """The input written by the port's writer, checked against the
    reference's writer's bytes."""
    path, ref = tmp_path / name, tmp_path / ("ref_" + name)
    write(str(path))
    jax_write(str(ref))
    assert path.read_bytes() == ref.read_bytes()
    return path


def _compactstream(tmp_path):
    sym = random_string(900, 8, seed=1)
    return _same_input(tmp_path, "x.compact",
                       lambda p: compact.write_compact(p, sym, 3),
                       lambda p: jax_compact.write_compact(p, sym, 3)), sym


def _lz4(tmp_path):
    data = bytes(random_string(1200, 5, seed=2).astype(np.uint8) + 97)
    return _same_input(
        tmp_path, "x.lz4",
        lambda p: write_lz4_stream(p, data, block_size=256),
        lambda p: jax_write_lz4_stream(p, data, block_size=256)), \
        np.frombuffer(data, np.uint8).astype(np.int32)


def _utf8(tmp_path):
    text = ("héllo wörld ünïcode çôdepoints " * 20) + "末端"
    p = tmp_path / "x.txt"
    p.write_text(text, encoding="utf-8")
    return p, np.array([ord(c) for c in text], dtype=np.int32)


def _pac(tmp_path):
    codes = random_string(700, 4, seed=3)
    return _same_input(tmp_path, "x.pac", lambda p: write_pac(p, codes),
                       lambda p: jax_write_pac(p, codes)), codes


def _digits(tmp_path):
    txt = tmp_path / "d.txt"
    txt.write_text("1415926535897932384626433832795" * 10)
    out, ref = str(tmp_path / "d.compact"), str(tmp_path / "ref_d.compact")
    assert dispatch(["digitsToCompact", "term=1", "outputfilename=" + out,
                     str(txt)]) == 0
    assert jax_dispatch(["digitsToCompact", "term=1",
                         "outputfilename=" + ref, str(txt)]) == 0
    assert open(out, "rb").read() == open(ref, "rb").read()
    sym, _bits = compact.read_compact(out)
    return out, sym


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's LZ4 writer takes its native codec, whatever the
    xdist build race left this worker (``test_torch_hostlayer.py``)."""
    with _reference_library(
            lambda: tmp_path_factory.mktemp("ref_native")) as ref:
        yield ref


CASES = {"compactstream": (_compactstream, "compactstream"),
         "lz4": (_lz4, "lz4"), "utf-8": (_utf8, "utf-8"),
         "pac": (_pac, "pac"), "digits": (_digits, "compactstream")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_input_type_builds_match_reference(tmp_path, name, ref_native):
    make, itype = CASES[name]
    inp, expect = make(tmp_path)
    outs = build_both(tmp_path, inp, input_type=itype,
                      preisa_sampling_rate=128)
    assert_same_files(outs, BWT_EXTS + SAMPLE_EXTS)
    res = outs["port"][1]
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(expect))
    assert check_bwt(res, np.asarray(expect, np.int32), device="cpu")
