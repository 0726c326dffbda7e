"""The protein cell, ``proteins.build``, on the CPU: a run at a small
size through the harness gives ``correct``; the control (a shortened
sort's files) fails the cell's check; each of the cell's per-layer
readers returns None on a trace without what it reads.

Run from the root of the repository:

    python -m pytest -q portbench/tests/test_portbench_proteins.py
"""

from __future__ import annotations

import io
import types

import numpy as np
import pytest

from portbench import harness
from portbench.conftest import small_text_config
from portbench.jobs import build_bytes

CELL = "proteins.build"
CONFIG = "pizzachili-proteins-bounded"
LAYERS = ["merge.gt_bits_s", "merge.chain_anchor_s", "io.bwt_write_s",
          "kernel.chain_roofline", "device.idle_share.build",
          "device.peak_gib.build", "merge.block_sorts_s",
          "merge.block_windows", "merge.rank_rows_s",
          "merge.anchor_rewalk_lanes"]
# the readers this cell brought
NEW = LAYERS[6:]


def small_protein_config(n: int, mem=None) -> dict:
    return small_text_config(CONFIG, n, mem)


def test_the_cell_is_declared():
    spec = harness.load_spec()
    work, config, traffic = harness.find_cell(spec, CELL)
    assert (work["config"], work["chips"]) == (CONFIG, 1)
    assert config["options"]["inputtype"] == "bytestream"
    assert harness.find_job(traffic["job"]).METRIC == "build_msym_s"
    assert [m["name"] for m in harness.end_to_end_of(spec, CELL)] == [
        "build_msym_s", "setup_s"]
    assert [m["name"] for m in harness.per_layer_of(spec, CELL)] == LAYERS


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(run_small, trace):
    rc, res, err = run_small(CELL, seed=2 ** 33 + 7, trace=trace)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0, err
    assert res["checks"]["files_wrong"] == {"value": 0, "limit": 0}
    if trace:
        # no card on the CPU: the device's readers have nothing to read
        assert set(res["metrics"]) == set(LAYERS) - {
            "kernel.chain_roofline", "device.idle_share.build",
            "device.peak_gib.build"}
        assert res["metrics"]["merge.block_windows"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"build_msym_s", "setup_s"}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 5 * 2 ** 32 + 9])
def test_shortened_sort_control_fails_the_check(tmp_path, seed):
    got, what = build_bytes.build_control(small_protein_config(60000), seed,
                                          str(tmp_path), "cpu")
    assert got["files_wrong"][0] > 0, what


def test_control_files_of_the_full_sort_pass_the_check(tmp_path):
    """The control's writer is sound: with the full sort in place of the
    shortened one, the cell's check reads 0."""
    import torch

    from portbench.reference import sa as rsa
    from portbench.traffic import protein
    cfg = small_protein_config(20000)
    pac = str(tmp_path / "proteins.txt")
    protein.write_text(pac, cfg["text"], 5)
    text = torch.from_numpy(np.fromfile(pac, np.uint8))
    build_bytes.write_files(str(tmp_path), text,
                            rsa.suffix_array(text, 256), 262144)
    ctx = types.SimpleNamespace(pac=pac, device="cpu", err=io.StringIO(),
                                builds=[{"dir": str(tmp_path)}])
    assert build_bytes.check(ctx) == {"files_wrong": (0, 0)}


@pytest.mark.parametrize("metric", NEW)
def test_readers_return_none_without_their_spans(metric):
    job = types.SimpleNamespace(builds=[{"phases": {"zip": 1.0},
                                         "spans": {}}],
                                window_ns=(0, 1), kernels=None,
                                err=io.StringIO())
    trace = types.SimpleNamespace(job=job, jobs=1, window_s=1.0,
                                  busy_s=0.0, peak_bytes=0, spans=None)
    assert harness.find_layer(metric).read(trace) is None
