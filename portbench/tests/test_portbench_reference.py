"""The plain reference against naive definitions and against the
program's own writers (the files are the program's formats, so the
reference must write what a correct build writes), and the controls."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from conftest import small_config
from portbench import control
from portbench.reference import align as ralign, files, sa as rsa


def _text(n, seed, sigma=5, repeat=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, sigma, n - 1).astype(np.uint8)
    if repeat:
        t[n // 2:n // 2 + repeat] = t[:repeat]
    return np.concatenate([t, [0]]).astype(np.uint8)


def _naive_sa(t):
    n = len(t)
    s = t.tobytes()
    return np.array(sorted(range(n), key=lambda i: s[i:] + s[:i]))


@pytest.mark.parametrize("n,seed,repeat", [(2, 0, 0), (17, 1, 0), (500, 2, 0),
                                           (800, 3, 300), (1000, 4, 450)])
def test_suffix_array_against_naive(n, seed, repeat):
    t = _text(n, seed, repeat=repeat)
    got = rsa.suffix_array(torch.from_numpy(t), 5).numpy()
    assert np.array_equal(got, _naive_sa(t))


def test_shortened_sort_orders_ties_by_position():
    t = _text(1000, 5, repeat=400)
    got = rsa.suffix_array(torch.from_numpy(t), 5, max_depth=40).numpy()
    s = t.tobytes() * 2
    # doubling stops at the first step of at least 40 symbols
    depth = 20
    while depth < 40:
        depth *= 2
    want = sorted(range(len(t)), key=lambda i: (s[i:i + depth], i))
    assert np.array_equal(got, np.array(want))
    assert not np.array_equal(got, _naive_sa(t))


def _port_bytes(write, *args):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "f")
        write(p, *args)
        return open(p, "rb").read()


@pytest.mark.parametrize("n,runs", [(1, 1), (1000, 7), (65536, 300),
                                    (200003, 40000), (300000, 5)])
def test_rlb1_matches_the_programs_writer(n, runs):
    from bwtb3m_tpu_torch.engine.result import write_bwt
    rng = np.random.default_rng(n)
    cuts = np.sort(rng.choice(np.arange(1, max(2, n)), min(runs, n) - 1,
                              replace=False)) if n > 1 else np.zeros(0, int)
    lens = np.diff(np.concatenate([[0], cuts, [n]]))
    syms = rng.integers(0, 5, len(lens)).astype(np.uint8)
    bwt = np.repeat(syms, lens)
    assert files.rlb1_bytes(torch.from_numpy(bwt), 5) == _port_bytes(
        write_bwt, bwt, 5)


def test_hist_and_sampled_arrays_match_the_programs_writers():
    from bwtb3m_tpu_torch.io import formats
    t = _text(5000, 9)
    hist = np.bincount(t, minlength=5)
    assert files.hist_bytes(hist) == _port_bytes(
        formats.write_hist, formats.hist_from_array(hist))
    v = np.arange(0, 5000, 7, dtype=np.int64)[::-1].copy()
    assert files.sampled_bytes(32, torch.from_numpy(v)) == _port_bytes(
        formats.write_sampled_array, 32, v)


@pytest.mark.parametrize("weights", [[1, 30, 20, 20, 29], [1, 1, 1, 1, 1],
                                     [5, 0, 9, 1, 2], [0, 4, 4, 4, 4]])
def test_hwt_matches_the_programs_writer(weights):
    from bwtb3m_tpu_torch.index.wavelet import HuffmanWaveletTree
    rng = np.random.default_rng(len(weights))
    p = np.array(weights, float) / sum(weights)
    bwt = rng.choice(5, 20000, p=p).astype(np.uint8)
    tree = HuffmanWaveletTree.build(bwt)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tree.write(os.path.join(d, "x.hwt"))
        want = open(os.path.join(d, "x.hwt"), "rb").read()
    assert files.hwt_bytes(torch.from_numpy(bwt), 5) == want


def test_preisa_check():
    t = _text(3000, 11)
    sa = rsa.suffix_array(torch.from_numpy(t), 5)
    isa = rsa.inverse(sa)
    pos = np.arange(0, 3000, 64)
    pairs = np.stack([isa.numpy()[pos], pos], 1).astype("<u8")
    meta = np.array([64, len(pos)], "<u8").tobytes()
    assert files.preisa_wrong(pairs.tobytes(), meta, isa) == 0
    assert files.preisa_wrong(pairs[::-1].tobytes(), meta, isa) == 0
    bad = pairs.copy()
    bad[3, 0] += 1
    assert files.preisa_wrong(bad.tobytes(), meta, isa) == 1
    assert files.preisa_wrong(pairs[:-1].tobytes(), meta, isa) > 0
    assert files.preisa_wrong(b"", b"", isa) > 0


def test_alignment_reference_against_brute_force():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 20000).astype(np.uint8)
    text[10000:10400] = text[2000:2400]          # a repeat: two hits
    idx = ralign.KmerIndex(torch.from_numpy(text))
    reads = np.stack([text[2100:2200], text[500:600],
                      3 - text[7000:7100][::-1],
                      rng.integers(0, 4, 100)]).astype(np.uint8)
    reads[1, [3, 50]] = (reads[1, [3, 50]] + 1) % 4     # 2 mismatches
    pats = torch.from_numpy(np.concatenate([reads, 3 - reads[:, ::-1]])
                            .astype(np.int64))
    pid, start, mis = (x.numpy() for x in ralign.hits(idx, pats, 2))
    want = []
    win = np.lib.stride_tricks.sliding_window_view(text, 100)
    for k, p in enumerate(pats.numpy()):
        d = (win != p).sum(1)
        want += [(k, s, int(d[s])) for s in np.flatnonzero(d <= 2)]
    assert list(zip(pid.tolist(), start.tolist(), mis.tolist())) == want
    recs = ralign.sam_records(idx, ["a", "b", "c", "d"], reads, 2)
    assert len(recs["a"]) == 2 and recs["a"][0].split("\t")[1] == "0"
    assert "NM:i:2" in recs["b"][0]
    assert recs["c"][0].split("\t")[1] == "16"
    assert recs["d"] == ["d\t4\t*\t0\t0\t*\t*\t0\t0\t%s\t*"
                         % "".join("ACGT"[c] for c in reads[3])]
    assert ralign.md_tag(np.array([0, 1, 2, 3]), np.array([0, 2, 2, 0])) \
        == "1C1T0"


@pytest.mark.parametrize("name,ssa", [("grch38-bwa-bounded", False),
                                      ("grch38-chr21-bwa", False),
                                      ("grch38-bwa-bounded", True)])
def test_shortened_sort_control_fails_the_check(tmp_path, name, ssa):
    cfg = small_config(name, 20000, exact_sd=True)
    got, what = control.build_control(cfg, 2 ** 31 + 3, str(tmp_path), "cpu",
                                      ssa=ssa)
    assert any(v > lim for v, lim in got.values()), (got, what)
    if ssa:
        assert got["files_wrong"][0] == 2


def test_control_files_of_the_full_sort_pass_the_check(tmp_path):
    """The control's writer is sound: with the full sort in place of the
    shortened one, the cell's check reads every number 0."""
    from portbench.jobs import build as bjob
    from portbench.traffic import genome
    cfg = small_config("grch38-chr21-bwa", 8000, exact_sd=True)
    fwd, _ = genome.forward_strand(cfg["genome"], 5)
    text = torch.from_numpy(genome.pacterm_symbols(fwd))
    control.write_files(str(tmp_path), text, rsa.suffix_array(text, 5),
                        cfg["options"])
    ctx = control._ctx(cfg, 5, "cpu", fwd)
    ctx.err = io.StringIO()
    ctx.builds = [{"dir": str(tmp_path)}]
    assert all(v == 0 for v, _lim in bjob.check(ctx).values())


def test_alignment_control_fails_the_check(tmp_path):
    import json
    cfg = small_config("grch38-chr21-bwa", 20000)
    with open(os.path.join(os.path.dirname(control.__file__), "traffic",
                           "reads_10k.json")) as f:
        traffic = json.load(f)
    traffic["reads_per_call"] = 500
    got, _what = control.align_control(cfg, traffic, 9, 2, str(tmp_path),
                                       "cpu")
    assert got["sam_wrong"][0] > 0
