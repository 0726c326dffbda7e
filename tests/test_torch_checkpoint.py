"""Merge-tree checkpointing of the port (``engine/checkpoint.py``).

Region files round-trip between the packages: a file the port writes
loads with the reference's ``load_region_file`` and the reverse, for
nibble (bits 4) and byte (bits 8) regions.  A build stopped by the
``<output>.stop`` kill file after k merges (pair by pair), or after a
batched level, resumes from the saved regions to outputs byte-identical
to an uninterrupted build, and saved regions of another text (a stale
key) are ignored.
"""

import glob
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.engine import checkpoint as jck
from bwtb3m_tpu.util.log import VerboseLog
from bwtb3m_tpu_torch.engine import checkpoint as pck
from bwtb3m_tpu_torch.engine import merge_scaled as ms
from bwtb3m_tpu_torch.engine.options import BwtOptions


def _region(rng, bits, n):
    bwt = rng.integers(0, 16 if bits == 4 else 256, n).astype(np.uint8)
    return (bwt, np.arange(0, n, 64, dtype=np.int64),
            rng.integers(0, n, (n + 63) // 64).astype(np.int64),
            int(rng.integers(0, n)),
            np.bincount(bwt, minlength=16 if bits == 4 else 256))


@pytest.mark.parametrize("bits,n", [(4, 1001), (4, 1000), (8, 777)])
def test_region_file_port_to_reference(tmp_path, bits, n):
    rng = np.random.default_rng(n)
    bwt, spos, srank, r0, hist = _region(rng, bits, n)
    path = str(tmp_path / "p.npz")
    pck.save_region_file(path, "key-1", 5, 5 + n, bits,
                         pck.pack_host(bwt, bits), spos, srank, r0, hist)
    s, e, got, gpos, grank, gr0, ghist = jck.load_region_file(path, "key-1")
    assert (s, e, gr0) == (5, 5 + n, r0)
    for a, b in ((got, bwt), (gpos, spos), (grank, srank), (ghist, hist)):
        np.testing.assert_array_equal(a, b)
    assert jck.load_region_file(path, "key-2") is None


@pytest.mark.parametrize("bits,n", [(4, 1001), (8, 777)])
def test_region_file_reference_to_port(tmp_path, bits, n):
    rng = np.random.default_rng(n + 1)
    bwt, spos, srank, r0, hist = _region(rng, bits, n)
    path = str(tmp_path / "j.npz")
    jck.save_region_file(path, "key-1", 0, n, bits, bwt, spos, srank, r0,
                         hist)
    s, e, got, gpos, grank, gr0, ghist = pck.load_region_file(path, "key-1")
    assert (s, e, gr0) == (0, n, r0)
    for a, b in ((got, bwt), (gpos, spos), (grank, srank), (ghist, hist)):
        np.testing.assert_array_equal(a, b)
    assert pck.load_region_file(path, "stale") is None
    with np.load(path) as z:     # the port writes the same packed bytes
        np.testing.assert_array_equal(pck.pack_host(bwt, bits), z["packed"])


def _opts(tmp_path, tag, **kw):
    kw.setdefault("checkpoint", True)
    # the stop tests count pair merges: pair by pair, as the reference's
    # tests/test_checkpoint.py builds (batched levels have their own test)
    kw.setdefault("batch_merges", False)
    return BwtOptions(input_path="x", device="cpu",
                      output_filename=str(tmp_path / (tag + ".bwt")),
                      max_block_symbols=1024, checkpoint_min_symbols=1, **kw)


def _build(text, opts):
    return ms.blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                                   sample_rate=256, lane_bucket=32,
                                   device="cpu")


def _regfiles(opts):
    return sorted(glob.glob(opts.tmp_prefix + "_BWTREG1_reg_*.npz"))


@pytest.mark.parametrize("k", [2, 4])
def test_stop_file_and_resume_bit_identical(tmp_path, monkeypatch, k):
    rng = np.random.default_rng(31)
    text = rng.integers(0, 4, 7000).astype(np.uint8)  # 7 blocks, 6 merges
    want = _build(text, _opts(tmp_path, "ref", checkpoint=False))
    opts = _opts(tmp_path, "run")
    stop = opts.output_filename + ".stop"
    real = ms._merge_pairs
    calls = {"n": 0, "stop_at": k}

    def merge_then_stop(ctx, pairs):
        out = real(ctx, pairs)
        calls["n"] += len(pairs)
        if calls["n"] == calls["stop_at"]:
            open(stop, "w").close()
        return out

    monkeypatch.setenv("BWTB3M_CKPT_SYNC", "1")
    monkeypatch.setattr(ms, "_merge_pairs", merge_then_stop)
    with pytest.raises(RuntimeError, match="stop requested"):
        _build(text, opts)
    assert _regfiles(opts)
    os.remove(stop)
    calls.update(n=0, stop_at=None)
    got = _build(text, opts)
    assert calls["n"] == 6 - k                # the rest of the merges
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert _regfiles(opts) == []              # removed after success


def test_stale_key_ignored(tmp_path, monkeypatch):
    monkeypatch.setenv("BWTB3M_CKPT_SYNC", "1")
    rng = np.random.default_rng(7)
    text1 = rng.integers(0, 4, 4000).astype(np.uint8)
    text2 = rng.integers(0, 4, 4000).astype(np.uint8)
    opts = _opts(tmp_path, "stale")
    real = ms._merge_pairs

    def one_then_stop(ctx, pairs):
        out = real(ctx, pairs)
        open(opts.output_filename + ".stop", "w").close()
        return out

    monkeypatch.setattr(ms, "_merge_pairs", one_then_stop)
    with pytest.raises(RuntimeError, match="stop requested"):
        _build(text1, opts)
    assert _regfiles(opts)
    os.remove(opts.output_filename + ".stop")
    monkeypatch.setattr(ms, "_merge_pairs", real)
    got = _build(text2, opts)        # same tmp prefix, another text
    want = _build(text2, _opts(tmp_path, "stale_ref", checkpoint=False))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_stop_after_a_batched_level_and_resume(tmp_path, monkeypatch):
    """With batched levels the kill file is seen between levels; the
    level's regions are saved at its end, and the resumed build loads
    them and ends byte-identical."""
    rng = np.random.default_rng(33)
    text = rng.integers(0, 4, 9000).astype(np.uint8)  # 9 blocks, 8 merges
    want = _build(text, _opts(tmp_path, "ref", checkpoint=False))
    opts = _opts(tmp_path, "run", batch_merges=True)
    stop = opts.output_filename + ".stop"
    real = ms._merge_pairs
    calls = {"levels": 0, "pairs": 0}

    def merges_then_stop(ctx, pairs):
        """A batch of two or more pairs is a level, a batch of one a
        single merge; the kill file appears after the first level."""
        out = real(ctx, pairs)
        calls["levels" if len(pairs) > 1 else "pairs"] += 1
        if calls["levels"] == 1 and len(pairs) > 1:
            open(stop, "w").close()
        return out

    monkeypatch.setenv("BWTB3M_CKPT_SYNC", "1")
    monkeypatch.setattr(ms, "_merge_pairs", merges_then_stop)
    with pytest.raises(RuntimeError, match="stop requested via .* after "
                                           "4/8 merges"):
        _build(text, opts)
    assert calls == {"levels": 1, "pairs": 0} and _regfiles(opts)
    os.remove(stop)
    got = _build(text, opts)
    # the first level comes back from its files; the second runs batched
    # again (nothing of it was saved), the last two merges are single
    assert calls == {"levels": 2, "pairs": 2}
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert _regfiles(opts) == []
