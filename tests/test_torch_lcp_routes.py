"""``compute_plcp``'s routes: a text just above 2^22 symbols forced onto
the device route and onto the slab route with ``BWTB3M_PLCP_DEV_BYTES``
gives the same (plcp, sa), equal to the host oracle's; the level descent
below 2^22 against the reference's; texts of 2^31 symbols or more raise
``ValueError`` on every route, as in the reference.  Exact equality; on
the CPU the Kasai walk runs its plain version."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.lcp import plcp as R
from bwtb3m_tpu_torch.lcp import plcp as P


class _Lines:
    def __init__(self):
        self.lines = []

    def v(self, msg, level=1):
        self.lines.append(msg)


def test_device_and_slab_routes_agree_above_2_22(monkeypatch):
    n = (1 << 22) + 37
    rng = np.random.default_rng(22)
    text = rng.integers(0, 4, n).astype(np.int32)
    text[1000:2000] = text[300000:301000]        # a long repeat
    out = {}
    for route, budget in (("device", 1 << 40), ("slab", 1)):
        monkeypatch.setenv("BWTB3M_PLCP_DEV_BYTES", str(budget))
        log = _Lines()
        out[route] = P.compute_plcp(text, 4, device="cpu", log=log)
        assert any("%s route" % route in ln for ln in log.lines), log.lines
    np.testing.assert_array_equal(out["device"][0], out["slab"][0])
    np.testing.assert_array_equal(out["device"][1], out["slab"][1])
    plcp, sa = out["device"]
    assert plcp.dtype == sa.dtype == np.int64
    np.testing.assert_array_equal(plcp, R.kasai_plcp(text, sa))
    assert int(plcp.max()) >= 1000


@pytest.mark.parametrize("n,sigma,kind", [(1 << 16, 4, "random"),
                                          (20011, 4, "periodic"),
                                          (9000, 256, "random")])
def test_level_descent_matches_reference(n, sigma, kind):
    rng = np.random.default_rng(n)
    if kind == "random":
        text = rng.integers(0, sigma, n).astype(np.int32)
    else:
        text = np.tile(rng.integers(0, sigma, 113), n // 113 + 1)[:n]
        text = text.astype(np.int32)
        text[rng.integers(0, n, 3)] = 1
    log = _Lines()
    plcp, sa = P.compute_plcp(text, sigma, device="cpu", log=log)
    assert any("level descent" in ln for ln in log.lines)
    rplcp, rsa = R.compute_plcp(text, sigma)
    np.testing.assert_array_equal(plcp, rplcp)
    np.testing.assert_array_equal(sa, rsa)


def test_texts_of_2_31_symbols_raise():
    """Every route refuses n >= 2^31 with the reference's exception type
    (its doubling sort raises ValueError there); zero-stride arrays stand
    in for the texts, so nothing of that size is allocated."""
    big = np.broadcast_to(np.uint8(1), (1 << 31,))
    with pytest.raises(ValueError, match="2\\^31"):
        P.compute_plcp(big, 4, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        P.compute_plcp_scaled(big, 4, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        P.compute_plcp_device(big, 4, torch.zeros(1, dtype=torch.int64),
                              device="cpu")
    with pytest.raises(ValueError, match="2\\^32"):
        P.compute_plcp_scaled(np.broadcast_to(np.uint8(1), (1 << 32,)), 4,
                              sa_isa=(None, None), device="cpu")
