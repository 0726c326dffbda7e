"""Whole runs of each cell on the CPU (the look for a card skipped) with
the timed path broken underneath: ``correct`` must come out false for
every fault the cell can have (a step that leaves its state unchanged,
half of a batch left out, an answer altered where it is produced), and
true for the sound program.  One chip, so no exchange between chips."""

from __future__ import annotations

import re
import types

import numpy as np
import pytest


@pytest.mark.parametrize("cell", ["grch38.build", "chr21.build", "chr21.align",
                                  "grch38.ssa"])
def test_sound_runs_are_correct(run_small, cell):
    rc, res, err = run_small(cell)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0, err
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["grch38.build", "chr21.build"])
def test_build_bwt_altered_where_written(run_small, monkeypatch, cell):
    from bwtb3m_tpu_torch.engine import api
    orig = api.write_bwt

    def altered(path, bwt, sigma):
        bwt = np.array(bwt, copy=True)
        i = len(bwt) // 2
        j = int(np.flatnonzero(bwt != bwt[i])[0])
        bwt[i], bwt[j] = bwt[j], bwt[i]          # same histogram
        orig(path, bwt, sigma)

    monkeypatch.setattr(api, "write_bwt", altered)
    rc, res, err = run_small(cell)
    assert rc == 0, err
    assert not res["correct"]
    assert res["checks"]["files_wrong"]["value"] > 0
    assert re.search(r"builds: bwt [1-9]", err)


@pytest.mark.parametrize("cell", ["grch38.build", "chr21.build"])
def test_build_that_leaves_its_state_unchanged(run_small, monkeypatch, cell):
    from bwtb3m_tpu_torch.engine import api
    monkeypatch.setattr(api, "compute_bwt",
                        lambda options, log=None: types.SimpleNamespace(n=1))
    rc, res, err = run_small(cell)
    assert rc == 0, err
    assert not res["correct"]


def test_ssa_sample_altered_where_produced(run_small, monkeypatch):
    from bwtb3m_tpu_torch.engine import ssa
    orig = ssa.harvest_walk

    def altered(*a, **kw):
        sa, isa = orig(*a, **kw)
        sa = sa.clone()
        sa[len(sa) // 2] += 1
        return sa, isa

    monkeypatch.setattr(ssa, "harvest_walk", altered)
    rc, res, err = run_small("grch38.ssa")
    assert rc == 0, err
    assert not res["correct"]
    assert res["checks"]["files_wrong"]["value"] > 0
    assert re.search(r"runs: sa [1-9]", err)


def test_ssa_that_leaves_its_state_unchanged(run_small, monkeypatch):
    from bwtb3m_tpu_torch.engine import ssa
    monkeypatch.setattr(ssa, "compute_ssa", lambda *a, **kw: None)
    rc, res, err = run_small("grch38.ssa")
    assert rc == 0, err
    assert not res["correct"]


def test_align_half_of_the_batch_left_out(run_small, monkeypatch):
    from bwtb3m_tpu_torch.apps import hamdna
    orig = hamdna.hamming_search_batch

    def half(fm, patterns, maxmis, shift=1):
        return orig(fm, list(patterns)[:len(patterns) // 2], maxmis, shift)

    monkeypatch.setattr(hamdna, "hamming_search_batch", half)
    rc, res, err = run_small("chr21.align")
    assert rc == 0, err
    assert not res["correct"]
    assert res["checks"]["sam_wrong"]["value"] > 0


def test_align_record_altered_where_produced(run_small, monkeypatch):
    from bwtb3m_tpu_torch.apps import hamdna
    orig = hamdna._md_and_nm

    def altered(ref, read):
        md, nm = orig(ref, read)
        return md, nm + 1

    monkeypatch.setattr(hamdna, "_md_and_nm", altered)
    rc, res, err = run_small("chr21.align")
    assert rc == 0, err
    assert not res["correct"]


def test_align_that_leaves_its_state_unchanged(run_small, monkeypatch):
    from bwtb3m_tpu_torch.apps import hamdna
    monkeypatch.setattr(hamdna, "all_ham_dna", lambda *a, **kw: 0)
    rc, res, err = run_small("chr21.align")
    assert rc == 0, err
    assert not res["correct"]
