"""The port's scaled merge engine against the reference's on the
repetitive and pacterm-like corpora of ``tests/test_merge_scaled.py``
(a 97-periodic text with 40 point mutations; sigma 5 with a unique
smallest terminator, the BWA pipeline's shape)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_merge_scaled import run_both


def test_scaled_matches_reference_repetitive(tmp_path):
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 4, 97)
    n = 4000
    text = np.tile(seg, n // 97 + 1)[:n].astype(np.uint8)
    idx = rng.integers(0, n, 40)
    text[idx] = rng.integers(0, 4, len(idx))
    run_both(tmp_path, text, 4, -(-n // 5), 512, 32)


def test_scaled_matches_reference_pacterm_like(tmp_path):
    rng = np.random.default_rng(9)
    n = 3333
    text = rng.integers(1, 5, n).astype(np.uint8)
    text[-1] = 0
    run_both(tmp_path, text, 5, -(-n // 4), 256, 64)
