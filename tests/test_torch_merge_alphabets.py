"""The port's merge engine against the reference's on the alphabet
corpora of ``tests/test_merge_scaled.py``: a full byte alphabet (symbols
>= 128, the int8 sign-extension trap) through the engine, and a wide
alphabet (utf-8 codepoints) that the API rank-compacts to bytes and maps
back, through ``compute_bwt``."""

import filecmp

import numpy as np
import pytest

pytest.importorskip("jax")

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from test_torch_merge_scaled import run_both


def test_scaled_matches_reference_bytestream_sigma256(tmp_path):
    rng = np.random.default_rng(21)
    n = 5000
    text = rng.integers(0, 256, n).astype(np.uint8)
    text[:16] = np.arange(240, 256)  # high bytes near the start
    run_both(tmp_path, text, 256, -(-n // 4), 512, 64)


def test_wide_alphabet_rank_compacted_matches_reference(tmp_path):
    rng = np.random.default_rng(29)
    alphabet = np.array([65, 955, 0x4E2D, 0x1F600, 97, 10], np.int32)
    text = alphabet[rng.integers(0, len(alphabet), 4000)]
    inp = tmp_path / "u.txt"
    inp.write_bytes("".join(chr(c) for c in text).encode("utf-8"))
    kw = dict(input_path=str(inp), input_type="utf-8", engine="merge",
              max_block_symbols=1024, preisa_sampling_rate=512,
              bwt_only=True, verbose=0)
    jax_compute_bwt(JaxOptions(output_filename=str(tmp_path / "j.bwt"),
                               **kw))
    compute_bwt(BwtOptions(output_filename=str(tmp_path / "p.bwt"),
                           device="cpu", **kw))
    for ext in ("bwt", "hist", "preisa"):
        assert filecmp.cmp(tmp_path / ("j." + ext), tmp_path / ("p." + ext),
                           shallow=False), ext
