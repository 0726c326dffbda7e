"""The LCP tools through ``python -m bwtb3m_tpu_torch ... device=cpu``
against ``python -m bwtb3m_tpu`` on the same build, as
``tests/test_cli.py::test_lcpbit_cli``: ``lcpbit``'s ``.lcpbit`` and
``hwtToLCP``'s ``.ulcp``, ``.lcp`` and ``.rmm`` byte-identical,
``checkLCPBit`` printing ``lcpok=1`` on either package's file and
``lcpok=0`` with exit 1 on a file with one bit moved, ``hwtToLCP
checklcp=1``, ``lcpbit -test``, and the files of each package read by
the other's readers."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu.lcp import plcp as R
from bwtb3m_tpu.lcp.rmm import RMMTree as RefRMMTree
from bwtb3m_tpu.lcp.wavelet_lcp import read_ulcp as ref_read_ulcp
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.lcp import plcp as P
from bwtb3m_tpu_torch.lcp.rmm import RMMTree
from bwtb3m_tpu_torch.lcp.wavelet_lcp import read_ulcp
from oracle import random_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def build(tmp_path):
    """A build by the reference package (bwtb3m of 600 DNA bytes, as
    tests/test_cli.py makes it); both packages' tools read its .meta."""
    data = bytes(random_string(600, 4, seed=13).astype(np.uint8) + 65)
    inp = tmp_path / "l.bin"
    inp.write_bytes(data)
    assert jax_dispatch(["bwtb3m", "verbose=0", str(inp)]) == 0
    return str(inp), str(inp) + ".bwt", np.frombuffer(data, np.uint8)


def test_lcp_tools_byte_identical(build, tmp_path, capsys):
    inp, bwt, text = build
    assert jax_dispatch(["lcpbit", bwt, inp + ".ref.lcpbit"]) == 0
    assert dispatch(["lcpbit", "device=cpu", bwt]) == 0
    assert _read(inp + ".lcpbit") == _read(inp + ".ref.lcpbit")
    assert jax_dispatch(["hwtToLCP", "checklcp=1", bwt]) == 0
    ref = {ext: _read(inp + ext) for ext in (".ulcp", ".lcp", ".rmm")}
    for ext in ref:
        os.unlink(inp + ext)
    assert dispatch(["hwtToLCP", "checklcp=1", "device=cpu", bwt]) == 0
    for ext, blob in ref.items():
        assert _read(inp + ext) == blob, ext
    # the .lcp of hwtToLCP is the .lcpbit of lcpbit
    assert ref[".lcp"] == _read(inp + ".lcpbit")
    capsys.readouterr()
    for lcpbit in (inp + ".lcpbit", inp + ".ref.lcpbit"):
        assert dispatch(["checkLCPBit", "device=cpu", lcpbit, bwt]) == 0
        assert capsys.readouterr().out.strip() == "lcpok=1"


def test_checklcpbit_rejects_a_moved_bit(build, tmp_path, capsys):
    """One bit of the payload moved by one place: the decoder still finds
    n ones, two neighbouring PLCP values change, and both packages'
    checkLCPBit print lcpok=0 and exit 1."""
    inp, bwt, _text = build
    assert dispatch(["lcpbit", "device=cpu", bwt]) == 0
    blob = bytearray(_read(inp + ".lcpbit"))
    body = np.frombuffer(bytes(blob[20:]), np.uint8)
    bits = np.unpackbits(body, bitorder="little")
    ones = np.flatnonzero(bits)
    # a one whose next bit is a zero: move it there
    j = next(int(i) for i in ones[1:] if i + 1 < len(bits) and not bits[i + 1])
    bits[j], bits[j + 1] = 0, 1
    blob[20:] = np.packbits(bits, bitorder="little").tobytes()
    bad = str(tmp_path / "bad.lcpbit")
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    capsys.readouterr()
    assert dispatch(["checkLCPBit", "device=cpu", bad, bwt]) == 1
    assert capsys.readouterr().out.strip() == "lcpok=0"
    assert jax_dispatch(["checkLCPBit", bad, bwt]) == 1
    assert capsys.readouterr().out.strip() == "lcpok=0"


def test_files_cross_load(build):
    inp, bwt, text = build
    assert dispatch(["hwtToLCP", "device=cpu", bwt]) == 0
    plcp, sa = P.compute_plcp(text.astype(np.int32), 256, device="cpu")
    lcp = plcp[sa]
    np.testing.assert_array_equal(R.PLCPBitDecoder(inp + ".lcp").all(), plcp)
    np.testing.assert_array_equal(ref_read_ulcp(inp + ".ulcp"), lcp)
    assert RefRMMTree.read(inp + ".rmm").rmq(3, 500) == RMMTree(lcp).rmq(
        3, 500)
    # and the reference's files in the port's readers
    assert jax_dispatch(["hwtToLCP", bwt]) == 0
    np.testing.assert_array_equal(P.PLCPBitDecoder(inp + ".lcp").all(), plcp)
    np.testing.assert_array_equal(read_ulcp(inp + ".ulcp"), lcp)
    assert RMMTree.read(inp + ".rmm").rmq(3, 500) == RMMTree(lcp).rmq(3, 500)


def test_lcpbit_selftest_through_the_module(tmp_path):
    """``python -m bwtb3m_tpu_torch lcpbit -test device=cpu`` exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "bwtb3m_tpu_torch", "lcpbit", "-test",
         "device=cpu"], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "lcpbit selftests ok" in proc.stdout


def test_usage_without_files(capsys):
    assert dispatch(["lcpbit", "device=cpu"]) == 1
    assert dispatch(["checkLCPBit", "device=cpu", "x.lcpbit"]) == 1
    assert dispatch(["hwtToLCP"]) == 1
    assert "usage" in capsys.readouterr().err
