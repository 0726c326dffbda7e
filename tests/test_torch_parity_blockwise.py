"""The blockwise grid of ``tests/test_merge.py``, the port against the
reference's legacy engine ``bwtb3m_tpu.engine.merge.blockwise_bwt``.

Each text (random DNA at 2-5 blocks, bytes over 200 symbols, a binary
text, a repetitive one whose repeats cross the block edges, a periodic
one, one and sixteen anchor segments) is built by the port on the CPU
with ``engine=merge-legacy`` and ``engine=merge`` at the grid's
``max_block_symbols``, with every SA and ISA entry sampled (rate 1).
The port's ``.bwt``, its full ``.sa`` and ``.isa`` and the ranks of its
``.preisa`` must equal the reference's BWT, SA and ISA (integers:
tolerance 0).  The periodic text is a power of a 3-symbol root: its
``engine=merge`` build runs with ``bwtonly=1``, since the scaled
engine's SA walk of a power text past one block raises in both packages
(ROADMAP.md Queue 3), and ``merge-legacy`` writes its files from the
root.  The grid's window sort resolves a whole rotation in both
packages with the same order; its gt-bit cases have no counterpart: the
port computes gt bits with the native comparator (``ops/gapdev.py``),
not ``compute_gt0``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine.merge import blockwise_bwt
from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
from bwtb3m_tpu.ops.windowsort import block_suffix_order as jax_block_order
from bwtb3m_tpu.util.log import VerboseLog
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.io import formats
from bwtb3m_tpu_torch.io.rl import rl_decode
from bwtb3m_tpu_torch.ops.windowsort import block_suffix_order
from oracle import random_string


def _grid():
    base = np.array([0, 0, 0, 1, 0, 0, 0, 1, 2], np.int32)
    cases = {"random-%d-%d" % (n, b): (random_string(n, 4, seed=n * 31 + b),
                                       (n + b - 1) // b, 4, 32)
             for n, b in ((64, 2), (100, 3), (256, 4), (500, 5))}
    cases.update({
        "bytes": (random_string(300, 200, seed=5), 90, 4, 32),
        "small-alphabet": (random_string(400, 2, seed=6), 128, 4, 32),
        "repetitive": (np.concatenate([np.tile(base, 30), [3]]), 64, 3, 8),
        "periodic": (np.tile([0, 1, 1], 40), 32, 4, 32),
        "single-segment": (random_string(200, 4, seed=9), 64, 1, 32),
        "many-segments": (random_string(512, 4, seed=10), 200, 16, 16),
    })
    return cases


GRID = _grid()


@pytest.mark.parametrize("engine", ["merge-legacy", "merge"])
@pytest.mark.parametrize("name", sorted(GRID))
def test_blockwise_grid_matches_reference(tmp_path, name, engine):
    text, max_block, segments, anchor = GRID[name]
    text = np.asarray(text, np.int32)
    sigma = int(text.max()) + 1
    sa, isa, bwt = blockwise_bwt(
        text, sigma, JaxOptions(input_path=str(tmp_path / "x"),
                                output_filename=str(tmp_path / "x.bwt"),
                                max_block_symbols=max_block,
                                large_lcp_thres=64),
        VerboseLog(0), num_segments=segments, anchor_lookback=anchor,
        merge_mode="tree")
    sa, isa = np.asarray(sa), np.asarray(isa)
    inp = tmp_path / "t.bin"
    inp.write_bytes(text.astype(np.uint8).tobytes())
    bwt_only = engine == "merge" and name == "periodic"
    res = compute_bwt(BwtOptions(
        input_path=str(inp), engine=engine, max_block_symbols=max_block,
        sa_sampling_rate=1, isa_sampling_rate=1, bwt_only=bwt_only,
        verbose=0, device="cpu"))
    np.testing.assert_array_equal(rl_decode(res.bwt_path), np.asarray(bwt))
    ranks, positions, _rate = res.load_preisa()
    np.testing.assert_array_equal(ranks, isa[positions])
    if not bwt_only:
        np.testing.assert_array_equal(
            formats.read_sampled_array(res.sa_path)[1], sa)
        np.testing.assert_array_equal(
            formats.read_sampled_array(res.isa_path)[1], isa)


def test_window_sort_resolved():
    """The whole text as one window: both orders agree (mismatch count 0)
    and equal the reference's resolved order."""
    text = random_string(64, 4, seed=0)
    window = np.concatenate([text, text[:32]])
    lo, hi, mismatches = block_suffix_order(torch.from_numpy(window), 64, 4)
    want_lo, want_hi, resolved = jax_block_order(window, 64, 4)
    assert mismatches == 0 and resolved
    np.testing.assert_array_equal(lo.numpy(), hi.numpy())
    np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(np.asarray(want_lo), np.asarray(want_hi))
