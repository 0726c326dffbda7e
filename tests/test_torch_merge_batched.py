"""Batched merge levels end to end against the reference package.

``compute_bwt`` at a small ``mem=`` with 5, 8 and 9 blocks (carried
regions on several levels), with ``batch_merges`` on and off, and the
reference's ``compute_bwt`` on the same input: ``.bwt``, ``.hist``,
``.preisa`` byte-identical and ``.meta`` equal as JSON apart from paths.
Exact equality; on the CPU the chains run their plain versions.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.engine import BwtOptions, check_bwt, compute_bwt
from bwtb3m_tpu_torch.util.log import VerboseLog


def _meta(path):
    meta = json.load(open(path))
    meta["files"] = {k: os.path.basename(v) for k, v in meta["files"].items()}
    return meta


@pytest.mark.parametrize("nblocks", [5, 8, 9])
def test_batched_build_matches_per_pair_and_reference(tmp_path, nblocks):
    rng = np.random.default_rng(40 + nblocks)
    block = 1024
    n = block * nblocks - 37                  # ragged last block
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    raw[2000:2400] = raw[300:700]             # a repeat across blocks
    inp = tmp_path / "t.bin"
    inp.write_bytes(raw.tobytes())
    kw = dict(input_path=str(inp), engine="merge", max_block_symbols=block,
              preisa_sampling_rate=256, bwt_only=True, verbose=0,
              lane_bucket=64)
    for d in ("jax", "batched", "pairs"):
        (tmp_path / d).mkdir()
    jax_compute_bwt(JaxOptions(
        output_filename=str(tmp_path / "jax/t.bwt"), **kw))
    msgs = []
    log = VerboseLog(0)
    log.v = lambda *a: msgs.append(a[0] if a else "")
    res = compute_bwt(BwtOptions(
        output_filename=str(tmp_path / "batched/t.bwt"), device="cpu",
        batch_merges=True, **kw), log)
    compute_bwt(BwtOptions(
        output_filename=str(tmp_path / "pairs/t.bwt"), device="cpu",
        batch_merges=False, **kw))
    # 5 blocks: one batched level; 8 and 9: two (4 pairs, then 2)
    assert sum("batched level" in m for m in msgs) == (1 if nblocks == 5
                                                        else 2)
    for other in ("jax", "pairs"):
        for ext in ("bwt", "hist", "preisa"):
            assert filecmp.cmp(tmp_path / ("batched/t." + ext),
                               tmp_path / (other + "/t." + ext),
                               shallow=False), (other, ext)
        assert _meta(tmp_path / "batched/t.meta") == \
            _meta(tmp_path / (other + "/t.meta"))
    assert check_bwt(res, raw, device="cpu")
