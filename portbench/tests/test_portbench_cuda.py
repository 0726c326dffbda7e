"""The small cells on the card, through the program's CUDA kernels:
correct, and a traced run whose shares stay within 100%.  Skips without
a card; run on a machine with one:

    python -m pytest -q -m cuda portbench/tests
"""

from __future__ import annotations

import io
import json
import time
import types

import pytest


def _run_on_card(spec, cell, trace=0):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=cell, seed=2 ** 31 + 17,
                                 seconds=0.5, trace=trace)
    rc = harness.run_cell(args, time.monotonic(), device="cuda", out=out,
                          err=err, spec=spec)
    assert rc == 0, err.getvalue()[-4000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grch38.build", "chr21.build", "chr21.align",
                                  "grch38.ssa"])
def test_small_cells_on_the_card(small_spec, cell):
    res, err = _run_on_card(small_spec, cell)
    assert res["correct"], err[-4000:]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grch38.build", "grch38.ssa",
                                  "chr21.align"])
def test_traced_shares_on_the_card(small_spec, cell):
    res, err = _run_on_card(small_spec, cell, trace=1)
    assert res["correct"], err[-4000:]
    assert res["device"]["busy_s"] > 0
    # the card's intervals fall inside the window on the host's clock,
    # also where the card alone was profiled (chr21.align)
    assert res["device"]["busy_s"] <= res["device"]["window_s"]
    assert any(name.startswith("device.idle_share") for name in
               res["metrics"]), res["metrics"]
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
