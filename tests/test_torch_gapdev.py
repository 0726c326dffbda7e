"""The port's gap runner against the reference's ``DeviceGapRunner``.

For pairs (s, m, e) over random, repetitive and sigma-2 texts, both
runners get the same right-region rank rows (the port's carried over
from the reference's by ``focc_from_jax``) and the same lanes.  Equal,
exactly: the runner inputs (``runner_inputs_from_jax``), both anchor
bounds and the resolved mask, the chain's final ranks, the gap histogram
(the reference's int32 histogram, cast to int64) and the harvested
samples.  The sigma-2 corpus is ``tests/test_merge_scaled.py::
test_gap_u16_wrap_fallback``'s, where one cell passes 2^16.  On the CPU
the port runs the walks' plain version.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# xdist runs several workers on shared cores: one intra-op thread each,
# or their OpenMP pools spin against each other (several times slower)
torch.set_num_threads(1)

from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.ops.focc_build import build_focc_host as jax_build_focc
from bwtb3m_tpu.ops.gapdev import DeviceGapRunner, build_text_rows
from bwtb3m_tpu_torch.ops.focc_build import focc_from_jax
from bwtb3m_tpu_torch.ops.gapdev import (GapRunner, cmp_rot,
                                         runner_inputs_from_jax)


def _text(kind):
    rng = np.random.default_rng(7)
    if kind == "random4":
        return rng.integers(0, 4, 6000).astype(np.uint8), 4
    if kind == "random200":
        return rng.integers(0, 200, 5000).astype(np.uint8), 200
    if kind == "repetitive":
        seg = rng.integers(0, 4, 97)
        t = np.tile(seg, 70)[:6000].astype(np.uint8)
        t[rng.integers(0, 6000, 30)] = rng.integers(0, 4, 30)
        return t, 4
    if kind == "u16wrap":            # a^(n-1) b: one cell gets 65,792
        t = np.zeros(65792 + 250, np.uint8)
        t[-1] = 1
        return t, 2
    raise KeyError(kind)


CASES = [("random4", 0, 2048, 4096), ("random4", 1000, 3000, 5200),
         ("random200", 0, 2560, 5000), ("repetitive", 512, 3000, 6000),
         ("u16wrap", 0, 65792, 66042)]


def _runners(kind, s, m, e, lanes=64, rate=128):
    text, sigma = _text(kind)
    n = len(text)
    sa, isa, _bwt = jax_suffix_array(text.astype(np.int32), sigma)
    sa, isa = np.asarray(sa), np.asarray(isa)
    right = sa[(sa >= m) & (sa < e)]         # rotation order of [m, e)
    rbwt = text[(right - 1) % n]
    r_start = int(np.flatnonzero(right == m)[0])
    hist = np.bincount(text[m:e], minlength=sigma)
    jfocc = jax_build_focc(rbwt, sigma)
    jr = DeviceGapRunner(jfocc, build_text_rows(text, sigma), text, s, m, e,
                         isa_m=r_start, first_hist=hist, lane_bucket=lanes,
                         sample_rate=rate)
    pr = GapRunner(focc_from_jax(jfocc), torch.from_numpy(text), text, s, m,
                   e, isa_m=r_start, first_hist=hist, sample_rate=rate)
    T = max(1, min(lanes, (m - s) // 64 or 1))
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    return jr, pr, bounds[1:] - 1, np.diff(bounds), r_start


@pytest.mark.parametrize("kind,s,m,e", CASES)
def test_anchors_match_reference(kind, s, m, e):
    jr, pr, starts, _lens, _r = _runners(kind, s, m, e)
    st = starts[:-1]
    for lb in (64, 1024):
        lbs = np.maximum(np.minimum(lb, (e - 2) - st), 1)
        for r0 in (0, pr.gap_size):
            np.testing.assert_array_equal(pr.anchor_bound(st, lbs, r0),
                                          jr._run_anchor(st, lbs, r0))
        lo_p, ok_p = pr.anchor(st, lb)
        lo_j, ok_j = jr.anchor(st, lb)
        np.testing.assert_array_equal(lo_p, lo_j)
        np.testing.assert_array_equal(ok_p, ok_j)


@pytest.mark.parametrize("kind,s,m,e", CASES)
def test_chains_match_reference(kind, s, m, e):
    jr, pr, starts, lens, r_start = _runners(kind, s, m, e)
    all_seeds = []
    for runner in (pr, jr):          # the engine's anchoring, on both
        seeds = np.zeros(len(starts), np.int64)
        seeds[-1] = r_start
        todo, lb = np.arange(len(starts) - 1), 64
        while len(todo):
            vals, ok = runner.anchor(starts[todo], lb)
            seeds[todo[ok]] = vals[ok]
            todo, lb = todo[~ok], lb * 4
        all_seeds.append(seeds)
    np.testing.assert_array_equal(*all_seeds)
    jr.run_chains(starts, seeds, lens, force_int32=True)
    pr.run_chains(starts, seeds, lens)
    np.testing.assert_array_equal(pr.final_rs, jr.final_rs)
    np.testing.assert_array_equal(pr.final_rs[1:], seeds[:-1])
    gj = np.asarray(jr.gap).astype(np.int64).reshape(-1)
    gp = pr.gap.numpy().astype(np.int64)
    np.testing.assert_array_equal(gp, gj[:len(gp)])
    assert not gj[len(gp):].any()
    assert pr.gap_checksum() == m - s == jr.gap_checksum()
    for a, b in zip(pr.harvest_samples(), jr.harvest_samples()):
        np.testing.assert_array_equal(a, b)
    if kind == "u16wrap":
        assert gp.max() >= 1 << 16
    ins = runner_inputs_from_jax(jr)
    np.testing.assert_array_equal(ins["c_first"], pr.c_first.numpy())
    np.testing.assert_array_equal(ins["consts"], np.array(pr.consts))
    assert ins["lo0"] == pr.lo0
    np.testing.assert_array_equal(ins["gt"][:len(pr._gt)], pr._gt)
    assert not ins["gt"][len(pr._gt):].any()


def test_cmp_rot_numpy_fallback_matches_native(monkeypatch):
    from bwtb3m_tpu import native
    rng = np.random.default_rng(2)
    text = np.tile(rng.integers(0, 3, 40), 30).astype(np.uint8)
    text[500] = 2
    xs = rng.integers(0, len(text), 300)
    want = cmp_rot(text, 777, xs)
    monkeypatch.setattr(native, "cmp_rot", lambda *a, **k: None)
    got = cmp_rot(text, 777, xs)
    np.testing.assert_array_equal(got, want)
    for x, g in zip(xs[:40], got[:40]):      # the definition, directly
        a, b = np.roll(text, -int(x)), np.roll(text, -777)
        d = np.flatnonzero(a != b)
        assert g == (0 if not len(d) else (1 if a[d[0]] > b[d[0]] else -1))
