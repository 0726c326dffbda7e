"""Protein texts through the port: the benchmark's generator
(``portbench/traffic/protein.py``) and ``compute_bwt`` with
``inputtype=bytestream`` on small seeded protein texts, single block and
through the scaled merge engine, against the plain reference
(``portbench/reference/``: doubling over rotations, no kernel of the
port): ``.bwt`` (RLB1 at sigma 256), ``.hist`` and ``.preisa``.  Exact
repeats longer than 1,024 residues make the block sorts grow their
lookahead and the anchors extend their lookback; the spans
``merge.block_sort`` and ``merge.anchor_extend`` record it.  CPU only.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from bwtb3m_tpu_torch.engine.api import compute_bwt
from bwtb3m_tpu_torch.engine.options import BwtOptions
from bwtb3m_tpu_torch.util import trace
from portbench.jobs import build, build_bytes
from portbench.reference import sa as rsa
from portbench.traffic import protein

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [5, 2 ** 31 + 11, 3 * 2 ** 32 + 7]

with open(os.path.join(ROOT, "portbench", "configs",
                       "pizzachili-proteins-bounded.json")) as _f:
    GROUP = json.load(_f)["text"]


def group(n: int, **changes) -> dict:
    """The configuration's text group at ``n`` bytes, with ``changes``."""
    g = copy.deepcopy(GROUP)
    g["text_bytes"] = n
    g.update(changes)
    return g


# i.i.d. residues, no copies
NO_REPEATS = dict(homolog={"share": 0.0, "substitution": [0.0, 0.0]},
                  exact={"share": 0.0})


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_is_deterministic_by_seed(seed):
    g = group(20000)
    a = protein.protein_text(g, seed)
    assert len(a) == 20000 and a.dtype == np.uint8
    assert np.array_equal(a, protein.protein_text(g, seed))
    assert not np.array_equal(a, protein.protein_text(g, seed + 1))
    assert not np.array_equal(a, protein.protein_text(g, seed, stream=9))


@pytest.mark.parametrize("seed", SEEDS)
def test_composition_lines_and_primitive(seed):
    g = group(400000)
    t = protein.protein_text(g, seed)
    assert protein.is_primitive(t)
    comp = protein.composition_of(g)
    assert set(np.unique(t).tobytes()) == set((
        "".join(comp) + "\n").encode())          # 25 distinct bytes
    res = t[t != ord("\n")]
    counts = np.bincount(res, minlength=256)
    total = sum(comp.values())
    for code, share in comp.items():
        got = 100.0 * counts[ord(code)] / len(res)
        assert abs(got - 100.0 * share / total) < 0.5, (code, got, share)
    lens = np.diff(np.flatnonzero(t == ord("\n"))) - 1
    assert lens.min() >= 30 and lens.max() <= 35000
    assert 250 < np.median(lens) < 350


def test_primitive_check_finds_powers():
    u = protein.protein_text(group(3000), 5)
    assert protein.is_primitive(u)
    assert not protein.is_primitive(np.tile(u, 2))
    assert not protein.is_primitive(np.tile(u[:1000], 15))
    assert protein.is_primitive(np.concatenate([np.tile(u[:1000], 3),
                                                u[:7]]))


def _build(tmp_path, text: np.ndarray, mem=None):
    """``compute_bwt`` of ``text`` as a bytestream on the CPU into
    ``tmp_path/genome.*``; returns (its spans, the merge.block_sort
    attrs in block order: the engine sorts the blocks left to right)."""
    path = str(tmp_path / "proteins.txt")
    text.tofile(path)
    opt = BwtOptions(input_path=path, input_type="bytestream",
                     output_filename=str(tmp_path / "genome.bwt"),
                     bwt_only=True, device="cpu", verbose=0,
                     **({"mem": mem} if mem else {}))
    lo = time.time_ns()
    compute_bwt(opt)
    recs = trace.records(lo, time.time_ns())
    return recs, [r.attrs for r in sorted(recs, key=lambda r: r.id)
                  if r.name == "merge.block_sort"]


def _wrong(tmp_path, text: np.ndarray) -> dict:
    t = torch.from_numpy(text)
    want = build_bytes.expected_files(t, rsa.suffix_array(t, 256))
    return build.compare_build(str(tmp_path), want)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("blocks", [1, 3, 5])
def test_files_match_the_reference(tmp_path, seed, blocks):
    n = 30000
    text = protein.protein_text(group(n), seed)
    # blocks of a multiple of 256 symbols: mem / 16 symbols each
    mem = 16 * 256 * -(-n // (256 * blocks)) if blocks > 1 else None
    _recs, sorts = _build(tmp_path, text, mem)
    assert len(sorts) == (0 if blocks == 1 else blocks)
    assert _wrong(tmp_path, text) == {"bwt": 0, "hist": 0, "preisa": 0}


def test_long_exact_repeats_grow_the_lookahead(tmp_path):
    """A 2,000-residue exact duplicate whose second copy crosses the end
    of the first block (8,192 symbols): the block's last positions tie
    through the 1,024-symbol lookahead, which grows to 4,096."""
    text = protein.protein_text(group(24000, **NO_REPEATS), 7)
    text[7692:9692] = text[1000:3000]
    assert protein.is_primitive(text)
    recs, sorts = _build(tmp_path, text, mem=16 * 8192)
    assert len(sorts) == 3
    # two windows at 1,024 (the pad-high one finds ties), one at 4,096
    assert (sorts[0]["windows"], sorts[0]["lookahead"]) == (3, 4096)
    assert [a["windows"] for a in sorts[1:]] == [1, 1]
    assert all(a["tie_positions"] == 0 for a in sorts)
    ext = [r.attrs for r in recs if r.name == "merge.anchor_extend"]
    assert ext and all(a["lanes"] > 0 for a in ext)
    assert max(a["lookback"] for a in ext) >= 1024
    assert _wrong(tmp_path, text) == {"bwt": 0, "hist": 0, "preisa": 0}


def test_a_text_without_repeats_sorts_each_block_once(tmp_path):
    text = protein.protein_text(group(24000, **NO_REPEATS), 7)
    _recs, sorts = _build(tmp_path, text, mem=16 * 8192)
    assert len(sorts) == 3
    assert [a["windows"] for a in sorts] == [1, 1, 1]
    assert [a["lookahead"] for a in sorts] == [1024] * 3
    assert _wrong(tmp_path, text) == {"bwt": 0, "hist": 0, "preisa": 0}
