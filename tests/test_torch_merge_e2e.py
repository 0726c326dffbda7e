"""The merge engine end to end against the reference package.

``python -m bwtb3m_tpu_torch bwtb3m engine=merge device=cpu`` with a
small ``mem=`` and the reference's ``compute_bwt(engine=merge)`` build
the same input: .bwt, .hist, .preisa (and with bwtonly=0 .sa, .isa,
.hwt) byte-identical, .meta equal as JSON apart from paths, and the
port's ``check_bwt`` accepts the merged build; ``engine=auto`` above one
block gives the doubling engine's files.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(path):
    meta = json.load(open(path))
    meta["files"] = {k: os.path.basename(v) for k, v in meta["files"].items()}
    return meta


@pytest.mark.parametrize("bwtonly", [0, 1])
def test_cli_merge_build_matches_reference(tmp_path, bwtonly):
    rng = np.random.default_rng(11 + bwtonly)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    raw[3000:3500] = raw[100:600]             # a repeat across blocks
    inp = tmp_path / "t.bin"
    inp.write_bytes(raw.tobytes())
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_compute_bwt(JaxOptions(
        input_path=str(inp), output_filename=str(tmp_path / "jax/t.bwt"),
        engine="merge", max_block_symbols=2048, preisa_sampling_rate=512,
        bwt_only=bool(bwtonly), verbose=0))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "bwtb3m_tpu_torch", "bwtb3m", "device=cpu",
         "verbose=0", "engine=merge", "mem=32768", "preisasamplingrate=512",
         "bwtonly=%d" % bwtonly,
         "outputfilename=%s" % (tmp_path / "port/t.bwt"), str(inp)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    exts = ("bwt", "hist", "preisa") + (() if bwtonly else
                                        ("sa", "isa", "hwt"))
    for ext in exts:
        assert filecmp.cmp(tmp_path / ("jax/t." + ext),
                           tmp_path / ("port/t." + ext), shallow=False), ext
    assert _meta(tmp_path / "jax/t.meta") == _meta(tmp_path / "port/t.meta")
    res = BwtResult.load(str(tmp_path / "port/t.bwt"))
    assert check_bwt(res, raw, device="cpu")


def test_auto_above_one_block_takes_merge_engine(tmp_path):
    rng = np.random.default_rng(4)
    raw = rng.integers(97, 101, 5000).astype(np.uint8)
    inp = tmp_path / "a.bin"
    inp.write_bytes(raw.tobytes())
    kw = dict(input_path=str(inp), preisa_sampling_rate=256, bwt_only=True,
              verbose=0)
    auto = compute_bwt(BwtOptions(output_filename=str(tmp_path / "m.bwt"),
                                  max_block_symbols=1024, device="cpu", **kw))
    dbl = compute_bwt(BwtOptions(output_filename=str(tmp_path / "d.bwt"),
                                 engine="doubling", device="cpu", **kw))
    for ext in ("bwt", "hist", "preisa"):
        assert filecmp.cmp(tmp_path / ("m." + ext), tmp_path / ("d." + ext),
                           shallow=False), ext
    assert check_bwt(auto, raw, device="cpu")
    assert dbl.n == auto.n
