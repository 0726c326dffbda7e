"""The device-rows hand-off of the port, after ``tests/test_rows_handoff.py``.

A merge-engine build binds its final region's packed symbols to the
``BwtResult`` it returns, for the ``.bwt`` it wrote; the first
``load_focc`` of that result builds the rank rows from them.  Nothing is
kept in the module: a result loaded from the file has no hand-off.  Held
here: the handle is used for the build's own file and gives the rows the
file gives; it never serves another file of the same n, nor a file
rewritten since, and is refused on an identity mismatch; an unrelated
build in between is not corrupted; and checkbwt's verdict is the same
with and without the hand-off, on a good and on a corrupted ``.bwt``.
The reference package runs the same sequences.
"""

import json
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import check_bwt as jax_check_bwt
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.io.pac import write_pac
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu_torch.engine import (BwtOptions, BwtResult, check_bwt,
                                     compute_bwt, compute_ssa)
from bwtb3m_tpu_torch.engine import result as result_mod
from bwtb3m_tpu_torch.engine.merge_scaled import DeviceRowsHandle
from bwtb3m_tpu_torch.engine.result import clear_caches, write_bwt
from bwtb3m_tpu_torch.io import formats


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_caches()
    yield
    clear_caches()


def _pac_build(tmp_path, seed, n=6000, opts=BwtOptions, build=compute_bwt,
               tag="g", **kw):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    p = str(tmp_path / ("%s%d.pac" % (tag, seed)))
    write_pac(p, codes)
    res = build(opts(input_path=p, input_type="pac", engine="merge",
                     max_block_symbols=2048, preisa_sampling_rate=512,
                     bwt_only=True, verbose=0, lane_bucket=32, **kw))
    return res, codes


def _rows_and_map(res):
    focc, symmap = res.load_focc("cpu")
    return focc.rows.numpy().copy(), focc.C.numpy().copy(), symmap


def test_handoff_serves_the_builds_own_file(tmp_path):
    res, codes = _pac_build(tmp_path, 21, device="cpu")
    _key, handle, symmap = res._device_rows
    assert symmap is None and handle.n == len(codes) and handle.sigma == 4
    rows, C, smap = _rows_and_map(res)           # consumes the hand-off
    assert res._device_rows is None and smap is None
    clear_caches()
    rows_f, C_f, smap_f = _rows_and_map(res)     # from the file
    np.testing.assert_array_equal(rows, rows_f)
    np.testing.assert_array_equal(C, C_f)
    assert smap_f is None
    assert check_bwt(res, codes, device="cpu")


def test_handoff_with_alphabet_compaction(tmp_path):
    rng = np.random.default_rng(51)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000)
    p = tmp_path / "t.bin"
    p.write_bytes(raw.tobytes())
    kw = dict(input_path=str(p), engine="merge", max_block_symbols=2048,
              preisa_sampling_rate=512, bwt_only=True, verbose=0,
              lane_bucket=32)
    res = compute_bwt(BwtOptions(device="cpu", **kw))
    assert res._device_rows is not None          # dense symbols + symmap
    rows, C, smap = _rows_and_map(res)
    assert res._device_rows is None
    np.testing.assert_array_equal(smap, [65, 67, 71, 84])
    clear_caches()
    rows_f, C_f, smap_f = _rows_and_map(res)
    np.testing.assert_array_equal(rows, rows_f)
    np.testing.assert_array_equal(C, C_f)
    np.testing.assert_array_equal(smap, smap_f)
    # the pipeline through the hand-off: checkbwt, then ssa on its memo
    clear_caches()
    res = compute_bwt(BwtOptions(device="cpu", **kw))
    assert check_bwt(res, raw, device="cpu")
    sa_path, _ = compute_ssa(res.bwt_path, 32, 64, device="cpu")
    sa = np.asarray(jax_suffix_array(raw.astype(np.int32), 256)[0])
    _r, sa_vals = formats.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, sa[::32])


def test_scaled_then_unrelated_build_is_uncorrupted(tmp_path):
    res_a, codes_a = _pac_build(tmp_path, 21, device="cpu")
    assert res_a._device_rows is not None        # pending, on A alone
    rng = np.random.default_rng(5)
    raw = rng.integers(97, 102, 3000).astype(np.uint8)
    pb = tmp_path / "b.bin"
    pb.write_bytes(raw.tobytes())
    res_b = compute_bwt(BwtOptions(input_path=str(pb), device="cpu",
                                   preisa_sampling_rate=256, verbose=0))
    assert check_bwt(res_b, raw, device="cpu")
    sa = np.asarray(jax_suffix_array(raw.astype(np.int32), 256)[0])
    rate, sa_vals = formats.read_sampled_array(res_b.sa_path)
    np.testing.assert_array_equal(sa_vals, sa[::rate])
    assert check_bwt(res_a, codes_a, device="cpu")


def test_two_scaled_builds_each_verify(tmp_path):
    res_a, codes_a = _pac_build(tmp_path, 31, device="cpu")
    res_b, codes_b = _pac_build(tmp_path, 32, n=5000, device="cpu")
    assert res_a._device_rows and res_b._device_rows   # each its own
    assert check_bwt(res_b, codes_b, device="cpu")
    assert check_bwt(res_a, codes_a, device="cpu")
    assert res_a._device_rows is None and res_b._device_rows is None
    sa_path, _ = compute_ssa(res_b.bwt_path, 32, 64, device="cpu")
    sa = np.asarray(jax_suffix_array(codes_b.astype(np.int32), 4)[0])
    _r, sa_vals = formats.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, sa[::32])


def test_handoff_refused_for_another_file_of_the_same_n(tmp_path):
    """A's pending symbols never serve B's file, though n and sigma are
    the same: the hand-off sits on A's result, keyed by the file the
    build wrote, and no module state carries it to another result."""
    res_b, codes_b = _pac_build(tmp_path, 62, device="cpu", tag="b")
    want = _rows_and_map(res_b)
    clear_caches()
    res_a, _codes_a = _pac_build(tmp_path, 61, device="cpu", tag="a")
    assert res_a._device_rows is not None and res_b._device_rows is None
    got = _rows_and_map(BwtResult.load(res_b.bwt_path))   # from B's file
    assert res_a._device_rows is not None        # A's is still pending
    np.testing.assert_array_equal(got[0], want[0])
    assert check_bwt(res_b, codes_b, device="cpu")
    assert res_a.n == res_b.n
    # the module keeps the rank-row memo and no other container
    assert [k for k, v in vars(result_mod).items()
            if isinstance(v, (dict, list, set)) and not k.startswith("__")
            ] == ["_FOCC_CACHE"]
    # A's symbols pointed at B's file by hand: the file key refuses them
    res_b._device_rows = res_a._device_rows
    clear_caches()
    got = _rows_and_map(res_b)
    np.testing.assert_array_equal(got[0], want[0])
    assert res_b._device_rows is None


@pytest.mark.parametrize("how", ["copy", "in_place"])
def test_handoff_does_not_mask_a_corrupted_bwt(tmp_path, how):
    """checkbwt on a corrupted .bwt says 0 with the hand-off pending, as
    it does without, and as the reference package does: a copy is
    another file, and a file rewritten in place has another mtime."""
    res, codes = _pac_build(tmp_path, 71, device="cpu")
    assert res._device_rows is not None
    bwt = res.load_bwt().astype(np.uint8)
    bwt[1234] = (bwt[1234] + 1) % 4
    if how == "copy":
        base = res.bwt_path[:-4]
        for ext in ("hist", "preisa"):
            shutil.copy(base + "." + ext, str(tmp_path / ("bad." + ext)))
        meta = json.load(open(base + ".meta"))
        meta["files"] = {k: str(tmp_path / ("bad." + k))
                         for k in meta["files"]}
        json.dump(meta, open(str(tmp_path / "bad.meta"), "w"))
        write_bwt(str(tmp_path / "bad.bwt"), bwt, 4)
        bad = BwtResult.load(str(tmp_path / "bad.bwt"))
    else:
        write_bwt(res.bwt_path, bwt, 4)
        bad = res
    assert not check_bwt(bad, codes, device="cpu")
    clear_caches()
    assert not check_bwt(bad, codes, device="cpu")     # without a hand-off
    if how == "copy":
        assert check_bwt(res, codes, device="cpu")

    # the reference package on the same sequence
    jres, jcodes = _pac_build(tmp_path, 71, opts=JaxOptions,
                              build=jax_compute_bwt, tag="j")
    from bwtb3m_tpu.io.rl import rl_encode
    rl_encode(jres.bwt_path, bwt, sigma=4)
    assert not jax_check_bwt(jres, jcodes.astype(np.int32))


def test_register_refuses_identity_mismatch(tmp_path):
    res, codes = _pac_build(tmp_path, 41, n=3000, device="cpu")
    hist = np.bincount(codes, minlength=4).astype(np.int64)
    packed = torch.zeros(1500, dtype=torch.uint8)
    h = DeviceRowsHandle(packed, 4, len(codes) + 1, 4, hist)
    with pytest.raises(ValueError):
        res.bind_device_rows(h, hist)
    bad = hist.copy()
    bad[0] += 1
    bad[1] -= 1
    h = DeviceRowsHandle(packed, 4, len(codes), 4, bad)
    with pytest.raises(ValueError):
        res.bind_device_rows(h, hist)
    h = DeviceRowsHandle(packed, 4, len(codes), 4, hist)
    with pytest.raises(ValueError):             # a symmap of another size
        res.bind_device_rows(h, hist, symmap=np.array([65, 67, 71]))
    res.bind_device_rows(h, hist)               # the matching one binds
    assert res._device_rows[1] is h


def test_no_handle_when_a_dense_remap_would_apply(tmp_path):
    """A text without one of its alphabet's symbols: the file build
    densifies, so the engine hands nothing over."""
    codes = np.random.default_rng(9).integers(0, 3, 5000).astype(np.uint8)
    p = str(tmp_path / "s.pac")
    write_pac(p, codes)
    res = compute_bwt(BwtOptions(
        input_path=p, input_type="pac", engine="merge", device="cpu",
        max_block_symbols=2048, preisa_sampling_rate=512, bwt_only=True,
        verbose=0, lane_bucket=32))
    assert res._device_rows is None
    assert check_bwt(res, codes, device="cpu")
