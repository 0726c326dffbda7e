"""The port's scaled merge engine against the reference's on the
adversarial periodic corpus of ``tests/test_merge_scaled.py``: block
sorts whose ties reach the window end and resolve through
``_resolve_tie_groups`` (``large_lcp_thres=1024``) without growing the
window."""

import numpy as np
import pytest

pytest.importorskip("jax")

from bwtb3m_tpu_torch.engine import merge_scaled as ms
from test_torch_merge_scaled import run_both


def test_scaled_matches_reference_adversarial_periodic(tmp_path,
                                                       monkeypatch):
    rng = np.random.default_rng(77)
    seg = rng.integers(0, 4, 16)
    n = 8192
    text = np.tile(seg, n // 16).astype(np.uint8)
    text[10] = (text[10] + 1) % 4
    text[7000] = (text[7000] + 2) % 4
    calls = []
    real = ms._resolve_tie_groups

    def probe(*a):
        out = real(*a)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(ms, "_resolve_tie_groups", probe)
    run_both(tmp_path, text, 4, 2048, 512, 32, large_lcp_thres=1024)
    assert calls and all(calls)       # resolved without growing the window
