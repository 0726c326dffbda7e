"""The port's gap runner, as a level of one merge, against the
reference's ``DeviceGapRunner``.

For pairs (s, m, e) over random, repetitive and sigma-2 texts, both
runners get the same right region (the port builds its rank rows from
the region's packed symbols; they equal the reference's rows carried
over by ``focc_from_jax``, as they are and, for sigma <= 4, repacked
into sector rows) and the same lanes.  Equal, exactly: the runner inputs
(``runner_inputs_from_jax``), both anchor bounds and the resolved mask,
the anchored seeds, the chain's final ranks, the gap histogram (the
reference's int32 histogram, cast to int64) and the harvested samples.  The sigma-2 corpus is ``tests/test_merge_scaled.py::
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
from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
from bwtb3m_tpu_torch.ops.focc_build import focc_from_jax
from bwtb3m_tpu_torch.ops.gapbatch import BatchedGapRunner, from_u32_bits
from bwtb3m_tpu_torch.ops.gapdev import cmp_rot, runner_inputs_from_jax


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


PAIRS = [("random4", 0, 2048, 4096), ("random4", 1000, 3000, 5200),
         ("random200", 0, 2560, 5000), ("repetitive", 512, 3000, 6000),
         ("u16wrap", 0, 65792, 66042)]
# every pair on the layout the engine takes for it, and the sigma-4
# pairs on the reference's bit-plane rows too; a right region of 65
# ranks ends one symbol into its second sector row
CASES = ([(*p, "auto") for p in PAIRS]
         + [(*p, "bitplane") for p in PAIRS[:2] + PAIRS[3:4]]
         + [("random4", 4000, 5935, 6000, "sector")])


def _runners(kind, s, m, e, layout, lanes=64, rate=128):
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
    pr = BatchedGapRunner(torch.from_numpy(text), text, sigma,
                          [(s, m, e, r_start, hist)],
                          [rows_from_host_bwt(rbwt, sigma, "cpu")],
                          bits_for(sigma), lane_bucket=lanes,
                          sample_rate=rate, layout=layout)
    pfocc = focc_from_jax(jfocc, layout=layout)
    assert pr.focc.LAYOUT == pfocc.LAYOUT == (
        "bytes" if sigma > 8 else "sector" if layout == "auto" else layout)
    nrows = pfocc.rows.shape[0]        # one spare zero row follows
    np.testing.assert_array_equal(pr.focc.rows.numpy()[:nrows],
                                  pfocc.rows.numpy())
    assert not pr.focc.rows.numpy()[nrows:].any()
    T = max(1, min(lanes, (m - s) // 64 or 1))
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    return jr, pr, bounds[1:] - 1, np.diff(bounds), r_start


@pytest.mark.parametrize("kind,s,m,e,layout", CASES)
def test_anchors_match_reference(kind, s, m, e, layout):
    jr, pr, starts, _lens, _r = _runners(kind, s, m, e, layout)
    st = starts[:-1]
    kid = np.zeros(len(st), np.int64)
    for lb in (64, 1024):
        lbs = np.maximum(np.minimum(lb, (e - 2) - st), 1)
        bounds = pr._anchor_pass(kid, st, lbs, np.full(len(st), 0),
                                 np.full(len(st), e - m))
        for got, r0 in zip(bounds, (0, e - m)):
            np.testing.assert_array_equal(got, jr._run_anchor(st, lbs, r0))
        lo_j, ok_j = jr.anchor(st, lb)
        np.testing.assert_array_equal(bounds[0], lo_j)
        np.testing.assert_array_equal(bounds[0] == bounds[1], ok_j)


@pytest.mark.parametrize("kind,s,m,e,layout", CASES)
def test_chains_match_reference(kind, s, m, e, layout):
    jr, pr, starts, lens, r_start = _runners(kind, s, m, e, layout)
    seeds = np.zeros(len(starts), np.int64)   # the engine's anchoring
    seeds[-1] = r_start
    todo, lb = np.arange(len(starts) - 1), 64
    while len(todo):
        vals, ok = jr.anchor(starts[todo], lb)
        seeds[todo[ok]] = vals[ok]
        todo, lb = todo[~ok], lb * 4
    jr.run_chains(starts, seeds, lens, force_int32=True)
    pr.compute()
    sp, pv = pr.specs[0], pr.view(0)
    assert sp.rbase == 0
    np.testing.assert_array_equal(sp.starts, starts)
    np.testing.assert_array_equal(sp.lens, lens)
    np.testing.assert_array_equal(sp.seeds, seeds)
    np.testing.assert_array_equal(pv.final_rs, jr.final_rs)
    np.testing.assert_array_equal(pv.final_rs[1:], seeds[:-1])
    gj = np.asarray(jr.gap).astype(np.int64).reshape(-1)
    gp = pv.gap.numpy().astype(np.int64)
    assert len(gp) == e - m + 1
    np.testing.assert_array_equal(gp, gj[:len(gp)])
    assert not gj[len(gp):].any()
    assert not pr.gap.numpy()[len(gp):].any()      # the gutter row's cells
    assert pv.gap_checksum() == m - s == jr.gap_checksum()
    for a, b in zip(pv.harvest_samples(), jr.harvest_samples()):
        np.testing.assert_array_equal(a, b)
    if kind == "u16wrap":
        assert gp.max() >= 1 << 16
    ins = runner_inputs_from_jax(jr)
    table = from_u32_bits(pr.table).numpy()[0]
    np.testing.assert_array_equal(ins["c_first"],
                                  from_u32_bits(pr.c_first).numpy())
    np.testing.assert_array_equal(ins["consts"], table[1:4])
    assert ins["lo0"] == table[4] == sp.lo0
    # the port lays the gt bits out for the whole pair; the reference's
    # cover what its walks reached
    both = min(len(ins["gt"]), len(pr._gt))
    np.testing.assert_array_equal(ins["gt"][:both], pr._gt[:both])
    assert not ins["gt"][both:].any() and not pr._gt[both:].any()


def test_cmp_rot_numpy_fallback_matches_native(monkeypatch):
    from bwtb3m_tpu_torch import native
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
