"""The port's windowed block sort against the reference package's.

``bwtb3m_tpu_torch.ops.windowsort`` must give the same window order and
fast-resolution flag as ``bwtb3m_tpu.ops.windowsort._window_order_flag``
(pad low and pad high), and the same block orders and mismatch count as
``_order_pair`` (the body of ``block_suffix_order_device``), exactly:
random text at sigma 4 and 200, periodic text (the pad-high confirmation
sort runs and disagrees), a window that wraps past n, and first-sort
keys with the top bit set (sigma 200 and 254 pack 8-bit symbols).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.ops.windowsort import _order_pair, _window_order_flag
from bwtb3m_tpu_torch.engine.merge_scaled import _Ctx, _device_window
from bwtb3m_tpu_torch.engine.options import BwtOptions
from bwtb3m_tpu_torch.ops.windowsort import block_suffix_order, window_order
from bwtb3m_tpu_torch.util.phases import Phases


def _window(kind, sigma, W, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, sigma, W).astype(np.uint8)
    if kind == "periodic":           # ties run to the window end
        return np.tile(rng.integers(0, sigma, 13), W // 13 + 1)[:W].astype(
            np.uint8)
    if kind == "repeats":            # a copied segment: long shared prefixes
        w = rng.integers(0, sigma, W).astype(np.uint8)
        w[900:1500] = w[100:700]
        return w
    raise KeyError(kind)


CASES = [("random", 4, 3000, 2000), ("random", 200, 2500, 1500),
         ("random", 254, 1800, 1024), ("periodic", 4, 3000, 2000),
         ("repeats", 4, 2600, 1800), ("periodic", 200, 1100, 1024)]


@pytest.mark.parametrize("kind,sigma,W,block", CASES)
def test_window_order_and_flag_match_reference(kind, sigma, W, block):
    win = _window(kind, sigma, W, W + sigma)
    for pad_high, la in ((False, W - block), (True, 0)):
        sa_j, fast_j = _window_order_flag(jnp.asarray(win.astype(np.int32)),
                                          sigma, pad_high, la)
        sa_p, fast_p = window_order(torch.from_numpy(win), sigma, pad_high,
                                    la)
        np.testing.assert_array_equal(sa_p.numpy(), np.asarray(sa_j))
        assert fast_p == bool(fast_j)


@pytest.mark.parametrize("kind,sigma,W,block", CASES)
def test_block_orders_match_reference(kind, sigma, W, block):
    win = _window(kind, sigma, W, W + sigma)
    lo_j, hi_j, mism_j = _order_pair(jnp.asarray(win.astype(np.int32)),
                                     block, sigma)
    lo_p, hi_p, mism_p = block_suffix_order(torch.from_numpy(win), block,
                                            sigma)
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_j))
    assert mism_p == int(mism_j)
    if kind == "periodic":
        assert mism_p > 0            # the confirmation sort ran


def test_window_wrapping_past_n():
    rng = np.random.default_rng(3)
    n, s, W, block = 2000, 1500, 1400, 384
    text = rng.integers(0, 4, n).astype(np.uint8)
    ctx = _Ctx(text, 4, 256, BwtOptions(input_path="x", device="cpu"), None,
               64, torch.device("cpu"), Phases("cpu"))
    win = _device_window(ctx, s, W)
    np.testing.assert_array_equal(win.numpy(),
                                  text[(s + np.arange(W)) % n])
    lo_j, hi_j, mism_j = _order_pair(
        jnp.asarray(win.numpy().astype(np.int32)), block, 4)
    lo_p, hi_p, mism_p = block_suffix_order(win, block, 4)
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_j))
    assert mism_p == int(mism_j)
