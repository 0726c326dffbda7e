"""Guards of the port: no JAX, no CPU fallback, explicit refusals.

- the ported slice runs with every import of ``jax``, ``jaxlib`` and the
  JAX package ``bwtb3m_tpu`` made to fail, and no file of the port
  imports any of them;
- ``device=cuda`` without CUDA raises instead of running on the CPU;
- paths that are not ported yet raise ``NotImplementedError`` naming
  their ROADMAP.md item, and the ones this refusal once covered run
  (``bwtcodec=rlh``, the tools past 256 symbols, the index tools and
  applications, the compact-file tools, ``engine=merge-legacy`` up to
  65,536 distinct symbols);
- a kernel build without ``nvcc`` raises, and the ctypes types of every
  kernel entry point follow its C signature.
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
        if name.split(".")[0] in ("jax", "jaxlib", "bwtb3m_tpu"):
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
assert dispatch(["hwtPreIsaToIsa", "device=cpu", "verbose=0", inp + ".bwt"]) == 0
out = inp + ".m.bwt"
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", "engine=merge",
                 "mem=16384", "outputfilename=" + out, inp]) == 0
assert dispatch(["checkbwt", "device=cpu", "verbose=0", inp, out]) == 0
assert dispatch(["lcpbit", "device=cpu", inp + ".bwt"]) == 0
assert dispatch(["checkLCPBit", "device=cpu", inp + ".lcpbit",
                 inp + ".bwt"]) == 0
assert dispatch(["hwtToLCP", "checklcp=1", "device=cpu", inp + ".bwt"]) == 0
u = inp + ".u8"
codes = (0x4e00 + rng.integers(0, 300, 3000)).astype("<u4")
open(u, "wb").write(codes.tobytes().decode("utf-32-le").encode("utf-8"))
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", "inputtype=utf-8",
                 "engine=merge", "mem=16384", "bwtcodec=rlh", u]) == 0
assert dispatch(["checkbwt", "device=cpu", "verbose=0", "inputtype=utf-8",
                 u, u + ".bwt"]) == 0
assert dispatch(["bwttestdecodespeed", "device=cpu", "verbose=0", "steps=8",
                 "maxstreams=8", u + ".bwt"]) == 0
from bwtb3m_tpu_torch.engine import select_ssa
assert len(select_ssa(u + ".bwt", np.arange(5), device="cpu")) == 5
from bwtb3m_tpu_torch.io.pac import write_pac
pac = inp + ".pac"
write_pac(pac, rng.integers(0, 4, 3000))
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", "inputtype=pacterm",
                 "sasamplingrate=8", "isasamplingrate=8", pac]) == 0
assert dispatch(["bwtdecodeblock", "device=cpu", pac + ".bwt", "10",
                 "20"]) == 0
fa = inp + ".fa"
open(fa, "w").write(">r\nACGTACGTTGCAACGT\n")
assert dispatch(["allHamDna", "device=cpu", "maxmis=1", pac + ".bwt",
                 fa]) == 0
assert dispatch(["probeScanDna", "device=cpu", "mode=occ", "k=8",
                 pac + ".bwt", fa]) == 0
assert dispatch(["hwtToRlHwt", "verify=1", "verbose=0", pac + ".bwt"]) == 0
assert dispatch(["bwtb3mtobwa", "verbose=0", pac + ".bwt", pac + ".b.bwt",
                 pac + ".b.sa"]) == 0
gfa = inp + ".g.fa"
open(gfa, "w").write(">a\nACGTNNacgtTTGA\n>b\nGGCATN\n")
assert dispatch(["fagzToCompact4", "verbose=0", gfa]) == 0
assert dispatch(["bwtb3m", "device=cpu", "verbose=0", "engine=merge-legacy",
                 "inputtype=compactstream", "outputfilename=" + gfa + ".bwt",
                 gfa + ".compact4"]) == 0
assert dispatch(["fa4suffixarraytocompact", "verbose=0", gfa + ".sa",
                 gfa + ".compact4.meta"]) == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bwtb3m_tpu"))
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
    assert "gok=1" in proc.stdout and "lcpok=1" in proc.stdout


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import jax|from jax|import bwtb3m_tpu(\.|\s|$)"
                     r"|from bwtb3m_tpu[. ])", re.M)
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
    ({"engine": "merge-legacy", "input_type": "utf-8"}, "item 11"),
    ({"engine": "sharded"}, "item 9"),
])
def test_unported_build_paths_raise(tmp_path, monkeypatch, kw, match):
    """``engine=sharded`` raises naming item 9; ``engine=merge-legacy``,
    which runs the scaled engine, raises naming item 11 on 65,537
    distinct code points, where the reference's legacy engine runs."""
    kw = dict(kw)
    if "env" in kw:
        monkeypatch.setenv(kw.pop("env"), "1")
    if kw.get("input_type") == "utf-8":
        p = tmp_path / "wide.txt"
        p.write_text("".join(map(chr, range(0x10000, 0x10000 + 65537))),
                     encoding="utf-8")
        inp = str(p)
    else:
        inp = _dna(tmp_path)
    opts = BwtOptions(input_path=inp, device="cpu", verbose=0, **kw)
    with pytest.raises(NotImplementedError, match=match):
        compute_bwt(opts)


@pytest.mark.parametrize("kw", [{"bwt_codec": "rlh"},
                                {"engine": "merge", "bwt_codec": "rlh"}])
def test_rlh_build_paths_run(tmp_path, kw):
    """bwtcodec=rlh (refused before the codec was ported) writes the
    reference's RLH1 .bwt with either engine, and checkbwt reads it."""
    from bwtb3m_tpu.engine import BwtOptions as JaxOptions
    from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
    inp = _dna(tmp_path)
    out = str(tmp_path / "p.bwt")
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu", verbose=0,
                                 output_filename=out, mem=16384, **kw))
    jax_compute_bwt(JaxOptions(input_path=inp, verbose=0, mem=16384,
                               output_filename=str(tmp_path / "r.bwt"),
                               **kw))
    assert open(out, "rb").read() == open(str(tmp_path / "r.bwt"),
                                          "rb").read()
    assert open(out, "rb").read(4) == b"RLH1"
    assert check_bwt(res, np.fromfile(inp, np.uint8), device="cpu")


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
    """A merge past 2^32 takes the wide path and is never batched: a
    batch that holds one is refused before anything runs (the wide path
    itself: tests/test_torch_gapwide.py)."""
    from bwtb3m_tpu_torch.engine import merge_scaled as ms
    reg = ms.Region(0, 1 << 32, None, np.zeros(1, np.uint8), None, None, 0,
                    None)
    right = ms.Region(1 << 32, (1 << 32) + 256, None, None, None, None, 0,
                      None)
    tail = ms.Region((1 << 32) + 256, (1 << 32) + 512, None, None, None,
                     None, 0, None)
    assert ms._is_wide(reg, right)
    assert not ms._level_fits_batched(None, [(reg, right), (right, tail)])
    with pytest.raises(ValueError, match="not batched"):
        ms._merge_pairs(None, [(reg, right), (right, tail)])


@pytest.mark.parametrize("kw", [{"engine": "merge"},
                                {"max_block_symbols": 256}])
def test_forced_wide_build_paths_run(tmp_path, monkeypatch, kw):
    """engine=merge and auto above max_block_symbols under
    BWTB3M_FORCE_WIDE take the wide merge path (they raised before it was
    ported) and build what checkbwt accepts."""
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    inp = _dna(tmp_path)
    res = compute_bwt(BwtOptions(input_path=inp, device="cpu", verbose=0,
                                 bwt_only=True, **kw))
    assert check_bwt(res, np.fromfile(inp, np.uint8), device="cpu")


def test_sigma_above_256_checks_raise(tmp_path):
    """checkbwt and bwtcomputessa past 256 symbols (refused before the
    wavelet rank rows were ported) run: gok, and the reference's .sa and
    .isa bytes.  What still raises there is the reference's int32 limit:
    ValueError from n = 2^31 on (tests/test_torch_legacy_walks.py)."""
    from bwtb3m_tpu.engine.ssa import compute_ssa as jax_compute_ssa
    from bwtb3m_tpu.io.inputtypes import parse_input_type
    p = tmp_path / "u.txt"
    # not a power of a shorter string: in both packages the SA walk of a
    # text with equal rotations misses positions and raises
    p.write_text("héllo 世界 " * 20 + "終", encoding="utf-8")
    res = compute_bwt(BwtOptions(input_path=str(p), input_type="utf-8",
                                 device="cpu", verbose=0))
    assert res.sigma > 256
    text, _s = parse_input_type("utf-8").load(str(p))
    assert check_bwt(BwtResult.load(res.bwt_path), text, device="cpu")
    sa_path, isa_path = compute_ssa(res.bwt_path, 4, 8, device="cpu")
    got = [open(f, "rb").read() for f in (sa_path, isa_path)]
    jax_compute_ssa(res.bwt_path, 4, 8)
    assert got == [open(f, "rb").read() for f in (sa_path, isa_path)]
    with pytest.raises(ValueError, match="2\\^31"):
        check_bwt(BwtResult({"n": 1 << 31, "sigma": 300, "files": {}}),
                  np.broadcast_to(np.int8(1), (1 << 31,)), device="cpu")


def test_cli_refuses_unported_tools(capsys):
    """Every one of the reference package's 29 tools is ported (the ten
    compact-file tools of item 8c were the last); each prints its usage
    without arguments, and an unknown tool exits 1."""
    from bwtb3m_tpu.cli import TOOLS as JAX_TOOLS, load_all
    from bwtb3m_tpu_torch import cli
    load_all()
    assert len(JAX_TOOLS) == 29
    assert sorted(cli.TOOLS) == sorted(JAX_TOOLS)
    assert not hasattr(cli, "NOT_PORTED")
    for name in ("fagzToCompact", "arraytocompact", "probeScanDna",
                 "allHamDna", "bwtb3mdecoderl", "bwtdecodeblock", "bwttohwt",
                 "hwtToRlHwt", "bwttodnarank", "bwttodnarank256",
                 "bwtb3mtobwa"):
        assert dispatch([name]) == 1, name
        assert "usage" in capsys.readouterr().err
    assert dispatch(["no-such-tool"]) == 1
    assert "unknown tool" in capsys.readouterr().err


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_types_match_the_c_signatures(name):
    """The ctypes types ``_build.load`` declares for each entry point of
    ``csrc/<name>.cu`` follow its ``extern "C"`` signature, parameter by
    parameter (a pointer, an ``int``, a ``long long``): ctypes would
    otherwise pass a wrong-sized argument to a kernel that no CPU test
    runs."""
    import ctypes
    src = open(os.path.join(_build.CSRC, name + ".cu")).read()
    sigs = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))

    def ctype(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    for fn, (argtypes, restype) in _build.ENTRY_POINTS[name].items():
        params = [p.strip() for p in sigs[fn].split(",")]
        assert [ctype(p) for p in params] == list(argtypes), fn
        assert restype is ctypes.c_int


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


def test_public_entry_points_default_to_the_card():
    """Every entry point runs on the card unless the caller asks for the
    CPU: none has a ``device`` default of ``"cpu"`` (the option set's
    default is ``"cuda"`` too)."""
    import inspect

    from bwtb3m_tpu_torch import engine
    from bwtb3m_tpu_torch.apps import hamdna, probescan
    from bwtb3m_tpu_torch.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m_tpu_torch.index import bidir, fm
    from bwtb3m_tpu_torch.lcp import plcp
    entry_points = [engine.compute_bwt, engine.check_bwt, engine.compute_ssa,
                    blockwise_bwt_scaled, engine.select_ssa,
                    engine.compute_sa_device, engine.compute_isa_from_preisa,
                    plcp.compute_plcp, plcp.compute_plcp_device,
                    plcp.compute_plcp_scaled, plcp.compute_plcp_file,
                    plcp.verify_plcp_file, fm.FMIndex,
                    fm.FMIndex.from_bwt_result, fm.fm_from_jax,
                    bidir.BidirectionalFMIndex,
                    bidir.BidirectionalFMIndex.from_text,
                    bidir.bidir_from_jax, probescan.probe_scan,
                    hamdna.all_ham_dna]
    with_device = 0
    for fn in entry_points:
        param = inspect.signature(fn).parameters.get("device")
        if param is None:
            continue            # compute_bwt: the device is in its options
        with_device += 1
        assert param.default is inspect.Parameter.empty \
            or torch.device(param.default).type == "cuda", fn.__name__
    assert with_device == len(entry_points) - 1
    assert BwtOptions(input_path="x").device == "cuda"
