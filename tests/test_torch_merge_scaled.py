"""The port's scaled merge engine against the reference's.

``bwtb3m_tpu_torch.engine.merge_scaled.blockwise_bwt_scaled`` must
return the same (bwt, preisa positions, preisa ranks, hist) as
``bwtb3m_tpu.engine.merge_scaled.blockwise_bwt_scaled`` on the corpora
of ``tests/test_merge_scaled.py``; this file holds the random (n,
blocks, rate) cases with aligned and ragged blocks, many levels and a
carried odd region, and ``run_both``, which the other
``test_torch_merge_*.py`` files share.  Exact equality; on the CPU the
chains run their plain version.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.engine.merge_scaled import blockwise_bwt_scaled as jax_scaled
from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
from bwtb3m_tpu.util.log import VerboseLog
from bwtb3m_tpu_torch.engine.merge_scaled import blockwise_bwt_scaled
from bwtb3m_tpu_torch.engine.options import BwtOptions


def run_both(tmp_path, text, sigma, max_block, rate, lanes, **kw):
    """Both engines on one text; asserts the four outputs are equal and
    returns the port's."""
    want = jax_scaled(text.astype(np.int32), sigma, JaxOptions(
        input_path="x", output_filename=str(tmp_path / "j.bwt"),
        max_block_symbols=max_block, **kw), VerboseLog(0),
        sample_rate=rate, lane_bucket=lanes)
    got = blockwise_bwt_scaled(text, sigma, BwtOptions(
        input_path="x", output_filename=str(tmp_path / "p.bwt"),
        max_block_symbols=max_block, device="cpu", **kw), VerboseLog(0),
        sample_rate=rate, lane_bucket=lanes, device="cpu")
    for name, g, w in zip(("bwt", "positions", "ranks", "hist"), got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64), err_msg=name)
    return got


@pytest.mark.parametrize("n,nb,rate", [
    (4096, 4, 256),   # 256-aligned blocks (rank at i == |M|)
    (5000, 3, 256),   # ragged tail block
    (3000, 7, 128),   # many levels + carried odd region
    (2048, 2, 32),    # single merge, dense sampling
])
def test_scaled_matches_reference_random(tmp_path, n, nb, rate):
    rng = np.random.default_rng(n + nb)
    text = rng.integers(0, 4, n).astype(np.uint8)
    _bwt, spos, _r, hist = run_both(tmp_path, text, 4, -(-n // nb), rate, 64)
    np.testing.assert_array_equal(spos, np.arange(0, n, rate))
    np.testing.assert_array_equal(hist, np.bincount(text, minlength=4))
