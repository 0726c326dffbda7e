"""The port's scaled merge engine against the reference's on two
corpora of ``tests/test_merge_scaled.py``: a fully periodic text with
genuinely equal rotations (ordered by position), and the sigma-2 text
where one gap cell passes 2^16 (the reference's uint16 histogram wraps
and reruns in int32; the port's is int32 throughout)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_merge_scaled import run_both


def test_scaled_matches_reference_fully_periodic(tmp_path):
    seg = np.array([1, 0, 2, 3, 2, 1, 0, 3], np.uint8)
    run_both(tmp_path, np.tile(seg, 512), 4, 1024, 512, 16,
             large_lcp_thres=512)


def test_scaled_matches_reference_gap_cell_past_2_16(tmp_path):
    n = 65792 + 250
    text = np.zeros(n, np.uint8)
    text[-1] = 1
    run_both(tmp_path, text, 2, 65792, 8192, 64)
