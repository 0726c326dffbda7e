"""The cases of ``tests/test_edges.py``, the port against the reference.

One symbol, two symbols and an all-same text build the reference's files
byte for byte (the port on the CPU) and pass the port's ``check_bwt``;
``checkbwt`` exits 1 on a corrupted ``.bwt`` in both packages; the UTF-8
decoder of ``bwtb3mdecoderl`` prints the same text in both;
``host_local_slice`` and the empty suffix array agree.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu.io.rl import rl_decode, rl_encode
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.parallel.dist import host_local_slice as jax_host_local_slice
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import check_bwt
from bwtb3m_tpu_torch.ops.doubling import suffix_array
from bwtb3m_tpu_torch.parallel.dist import host_local_slice, session
from oracle import naive_bwt
from torch_parity import BWT_EXTS, SAMPLE_EXTS, assert_same_files, build_both


@pytest.mark.parametrize("data", [
    pytest.param(b"a", id="one"), pytest.param(b"ba", id="two"),
    pytest.param(b"a" * 257, id="all-same")])
def test_tiny_texts_match_reference(tmp_path, data):
    inp = tmp_path / "t.bin"
    inp.write_bytes(data)
    outs = build_both(tmp_path, inp)
    assert_same_files(outs, BWT_EXTS + SAMPLE_EXTS)
    res = outs["port"][1]
    text = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(text))
    assert check_bwt(res, text.astype(np.int32), device="cpu")


def test_checkbwt_cli_corruption_exit_code(tmp_path):
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(97, 101, 500, dtype=np.uint8))
    rcs = {}
    for name, run in (("port", dispatch), ("ref", jax_dispatch)):
        d = tmp_path / name
        d.mkdir()
        inp = d / "c.bin"
        inp.write_bytes(data)
        extra = ["device=cpu"] if name == "port" else []
        assert run(["bwtb3m", "verbose=0", *extra, str(inp)]) == 0
        check = ["checkbwt", "inputtype=bytestream", *extra, str(inp),
                 str(inp) + ".bwt"]
        ok = run(check)
        bwt = rl_decode(str(inp) + ".bwt")
        i = int(np.flatnonzero(bwt[1:] != bwt[:-1])[0])
        bwt[i], bwt[i + 1] = bwt[i + 1], bwt[i]
        rl_encode(str(inp) + ".bwt", bwt, sigma=256)
        rcs[name] = (ok, run(check))
    assert rcs["port"] == rcs["ref"] == (0, 1)


def test_decoder_utf8(tmp_path, capsysbinary):
    text = "héllo ünïcode"
    outs = {}
    for name, run in (("port", dispatch), ("ref", jax_dispatch)):
        d = tmp_path / name
        d.mkdir()
        inp = d / "u.txt"
        inp.write_text(text, encoding="utf-8")
        extra = ["device=cpu"] if name == "port" else []
        assert run(["bwtb3m", "inputtype=utf-8", "verbose=0", *extra,
                    str(inp)]) == 0
        capsysbinary.readouterr()
        assert run(["bwtb3mdecoderl", "format=utf-8",
                    str(inp) + ".bwt"]) == 0
        outs[name] = capsysbinary.readouterr().out.decode("utf-8")
    codes = np.array([ord(c) for c in text], np.int32)
    assert outs["port"] == outs["ref"] == "".join(
        chr(int(c)) for c in naive_bwt(codes))


@pytest.mark.parametrize("n", [800, 7, 0])
def test_host_local_slice(n):
    """A single process (a group of one over gloo here) loads the whole
    range, as the reference's single host does."""
    with session("cpu") as mesh:
        got = host_local_slice(n, mesh)
    assert got == jax_host_local_slice(n) == slice(0, n)


def test_suffix_array_empty():
    for sa, isa, bwt in (suffix_array(np.zeros(0, np.int32), 4, "cpu"),
                         jax_suffix_array(np.zeros(0, np.int32), 4)):
        assert len(sa) == len(isa) == len(bwt) == 0
