"""Block regions and single pair merges against the reference.

The reference's ``_sort_block_scaled`` and ``_merge_pair_scaled`` run on
a text, and ``region_from_jax`` carries their regions over.  The port's
``_sort_block`` on the same text gives the same region (BWT, samples,
r_start, hist), and its ``_merge_pair`` fed the reference's own block
regions gives the reference's merged region, so each half of the engine
is held alone.  Exact equality; on the CPU the chains run their plain
version.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.engine import merge_scaled as jms
from bwtb3m_tpu.engine.options import BwtOptions as JaxOptions
from bwtb3m_tpu.util.log import VerboseLog
from bwtb3m_tpu_torch.engine import merge_scaled as ms
from bwtb3m_tpu_torch.engine.options import BwtOptions
from bwtb3m_tpu_torch.util.phases import Phases


def _text(kind):
    rng = np.random.default_rng(21)
    if kind == "random4":
        return rng.integers(0, 4, 3000).astype(np.uint8), 4
    if kind == "random200":
        return rng.integers(0, 200, 2500).astype(np.uint8), 200
    seg = rng.integers(0, 4, 89)                 # repetitive
    t = np.tile(seg, 40)[:3400].astype(np.uint8)
    t[rng.integers(0, 3400, 12)] = rng.integers(0, 4, 12)
    return t, 4


CASES = [("random4", 1024, 128), ("random200", 1024, 64),
         ("repetitive", 1280, 256)]


def _contexts(kind, block, rate):
    text, sigma = _text(kind)
    jctx = jms._Ctx(text, sigma, rate, JaxOptions(
        input_path="x", max_block_symbols=block), VerboseLog(0), 64)
    pctx = ms._Ctx(text, sigma, rate, BwtOptions(
        input_path="x", max_block_symbols=block, device="cpu"), None, 64,
        torch.device("cpu"), Phases("cpu"))
    return jctx, pctx, ms._plan_blocks_fixed(len(text), block)


def _assert_same(ctx, got: ms.Region, want: ms.Region):
    assert (got.s, got.e, got.r_start) == (want.s, want.e, want.r_start)
    np.testing.assert_array_equal(ms._region_bwt(ctx, got),
                                  ms._region_bwt(ctx, want))
    for name in ("samp_pos", "samp_rank", "hist"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("kind,block,rate", CASES)
def test_block_regions_match_reference(kind, block, rate):
    jctx, pctx, blocks = _contexts(kind, block, rate)
    for s, e in blocks:
        want = ms.region_from_jax(jms._sort_block_scaled(jctx, s, e),
                                  pctx.sigma)
        _assert_same(pctx, ms._sort_block(pctx, s, e), want)


@pytest.mark.parametrize("kind,block,rate", CASES)
def test_pair_merge_of_reference_regions(kind, block, rate):
    jctx, pctx, blocks = _contexts(kind, block, rate)
    (s, m), (_m, e) = blocks[:2]
    jl = jms._sort_block_scaled(jctx, s, m)
    jr = jms._sort_block_scaled(jctx, m, e)
    want = ms.region_from_jax(jms._merge_pair_scaled(jctx, jl, jr),
                              pctx.sigma)
    got = ms._merge_pair(pctx, ms.region_from_jax(jl, pctx.sigma),
                         ms.region_from_jax(jr, pctx.sigma))
    _assert_same(pctx, got, want)
