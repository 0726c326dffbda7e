"""Guards of the port: no JAX, no CPU fallback, explicit refusals.

- the ported slice runs with every ``import jax`` / ``import jaxlib``
  made to fail, and no file of the port imports JAX;
- ``device=cuda`` without CUDA raises instead of running on the CPU;
- paths that are not ported yet raise ``NotImplementedError`` (or, on
  the CLI, exit 2 naming their ROADMAP.md item);
- a kernel build without ``nvcc`` raises.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt, compute_ssa)
from bwtb3m_tpu_torch.ops import _build
from bwtb3m_tpu_torch.ops import lf_walk as lw
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from bwtb3m_tpu_torch.util.devices import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bwtb3m_tpu_torch")

BLOCKED_RUN = r'''
import importlib.abc, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
from bwtb3m_tpu_torch.cli import dispatch
inp = sys.argv[1]
rng = np.random.default_rng(1)
open(inp, "wb").write(rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000).tobytes())
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", inp]) == 0
assert dispatch(["checkbwt", "device=cpu", "verbose=0", inp, inp + ".bwt"]) == 0
assert dispatch(["bwtcomputessa", "device=cpu", "verbose=0", inp + ".bwt"]) == 0
out = inp + ".m.bwt"
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", "engine=merge",
                 "mem=16384", "outputfilename=" + out, inp]) == 0
assert dispatch(["checkbwt", "device=cpu", "verbose=0", inp, out]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print("OK")
'''


def test_slice_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "t.bin")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert "gok=1" in proc.stdout


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                if pat.search(open(path).read()):
                    offenders.append(path)
    assert not offenders


def _dna(tmp_path, n=600):
    p = tmp_path / "d.bin"
    rng = np.random.default_rng(n)
    p.write_bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())
    return str(p)


def test_cuda_requested_without_cuda_raises(tmp_path, monkeypatch):
    inp = _dna(tmp_path)
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu", verbose=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        compute_bwt(BwtOptions(input_path=inp, verbose=0))
    text = np.fromfile(inp, np.uint8)
    with pytest.raises(RuntimeError):
        check_bwt(res, text)
    with pytest.raises(RuntimeError):
        compute_ssa(res.bwt_path)
    with pytest.raises(RuntimeError):
        dispatch(["checkbwt", inp, res.bwt_path])


@pytest.mark.parametrize("kw,match", [
    ({"engine": "merge-legacy"}, "item 10"),
    ({"engine": "sharded"}, "item 9"),
    ({"bwt_codec": "rlh"}, "item 8"),
    ({"host_mem": 1 << 20}, "item 4"),
    ({"engine": "merge", "env": "BWTB3M_FORCE_WIDE"}, "item 6"),
    ({"max_block_symbols": 256, "env": "BWTB3M_FORCE_WIDE"}, "item 6"),
])
def test_unported_build_paths_raise(tmp_path, monkeypatch, kw, match):
    kw = dict(kw)
    if "env" in kw:
        monkeypatch.setenv(kw.pop("env"), "1")
    opts = BwtOptions(input_path=_dna(tmp_path), device="cpu", verbose=0,
                      **kw)
    with pytest.raises(NotImplementedError, match=match):
        compute_bwt(opts)


@pytest.mark.parametrize("kw", [{"engine": "merge"},
                                {"max_block_symbols": 256}])
def test_merge_engine_paths_run(tmp_path, kw):
    """engine=merge, and auto above max_block_symbols, take the scaled
    merge engine (they raised before it was ported)."""
    inp = _dna(tmp_path)
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu", verbose=0,
                                 bwt_only=True, **kw))
    assert check_bwt(res, np.fromfile(inp, np.uint8), device="cpu")


def test_merge_engine_refuses_wide_merges(tmp_path):
    from bwtb3m_tpu_torch.engine import merge_scaled as ms
    reg = ms.Region(0, 1 << 32, None, np.zeros(1, np.uint8), None, None, 0,
                    None)
    right = ms.Region(1 << 32, (1 << 32) + 256, None, None, None, None, 0,
                      None)
    with pytest.raises(NotImplementedError, match="item 6"):
        ms._merge_pair(None, reg, right)


def test_sigma_above_256_checks_raise(tmp_path):
    p = tmp_path / "u.txt"
    p.write_text("héllo 世界 " * 20, encoding="utf-8")
    res = compute_bwt(BwtOptions(input_path=str(p), input_type="utf-8",
                                 device="cpu", verbose=0))
    assert res.sigma > 256
    from bwtb3m_tpu.io.inputtypes import parse_input_type
    text, _s = parse_input_type("utf-8").load(str(p))
    with pytest.raises(NotImplementedError, match="item 8"):
        check_bwt(BwtResult.load(res.bwt_path), text, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        compute_ssa(res.bwt_path, device="cpu")


def test_cli_refuses_unported_tools(capsys):
    assert dispatch(["lcpbit", "x"]) == 2
    assert "ROADMAP.md Queue 1 item 7" in capsys.readouterr().err
    assert dispatch(["hwtPreIsaToIsa", "x"]) == 2
    assert dispatch(["bwttohwt", "x"]) == 2
    assert dispatch(["no-such-tool"]) == 1


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_wrapper_refuses_other_devices():
    focc = build_focc_host(np.zeros(10, np.uint8), 1, "cpu")
    with pytest.raises(ValueError, match="no LF-walk kernel"):
        lw.lf_walk(focc, torch.zeros(3, dtype=torch.int64, device="meta"), 1)


def test_check_bwt_text_of_other_length_fails(tmp_path):
    inp = _dna(tmp_path)
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu", verbose=0))
    text = np.fromfile(inp, np.uint8)
    assert check_bwt(res, text, device="cpu")
    assert not check_bwt(res, text[:-1], device="cpu")
