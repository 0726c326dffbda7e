"""The per-layer metrics that read the program's own spans
(``bwtb3m_tpu_torch/util/trace.py``): each reads a positive value in a
traced CPU run of its cell, nothing outside the traced window counts,
and a window without the spans reads None."""

from __future__ import annotations

import time
import types

import pytest

from portbench import harness

SPAN_METRICS = {
    "grch38.ssa": ("index.rows_decode_s", "index.rows_densify_s",
                   "index.rows_build_s"),
    "chr21.build": ("engine.host_inverse_s",),
    "chr21.align": ("apps.emit_ms_per_kread",),
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_reads_the_programs_spans(run_small, cell):
    rc, res, err = run_small(cell, seconds=0.05, trace=1)
    assert rc == 0 and res["correct"], err
    for name in SPAN_METRICS[cell]:
        assert res["metrics"][name]["value"] > 0, (name, res["metrics"])
    spec = harness.load_spec()
    listed = {m["name"] for m in harness.per_layer_of(spec, cell)}
    assert set(SPAN_METRICS[cell]) <= listed
    # the spans annotate the profiler's trace: idle stretches on the
    # CPU (no device) go to the program's host steps by name
    if cell == "grch38.ssa":
        named = {name for name, _s in res["breakdown"]["idle_gaps"]}
        assert named & {"bwtb3m::index.rows.decode",
                        "bwtb3m::index.rows.densify",
                        "bwtb3m::index.rows.build"}, named


def _trace_of(lo, hi):
    return types.SimpleNamespace(job=types.SimpleNamespace(
        window_ns=(lo, hi)))


def _job(tracer, root, step, sleep_s, **attrs):
    with tracer.span(root, **attrs):
        with tracer.span(step):
            time.sleep(sleep_s)


@pytest.mark.parametrize("metric,root,step,attrs,scale", [
    ("index.rows_decode_s", "engine.ssa", "index.rows.decode", {}, 1.0),
    ("index.rows_densify_s", "engine.ssa", "index.rows.densify", {}, 1.0),
    ("index.rows_build_s", "engine.ssa", "index.rows.build", {}, 1.0),
    ("engine.host_inverse_s", "engine.build", "engine.sort.host_inverse",
     {}, 1.0),
    ("apps.emit_ms_per_kread", "apps.align", "apps.emit", {"reads": 500},
     1e3 / 0.5),
])
def test_only_the_windows_jobs_count(metric, root, step, attrs, scale):
    from bwtb3m_tpu_torch.util import trace as tracer
    read = harness.find_layer(metric).read
    # set-up: a warm-up job, and the step outside any root
    _job(tracer, root, step, 0.05, **attrs)
    with tracer.span(step):
        time.sleep(0.05)
    lo = time.time_ns()
    assert read(_trace_of(lo, time.time_ns())) is None
    for _ in range(2):
        _job(tracer, root, step, 0.01, **attrs)
    hi = time.time_ns()
    # a job after the window
    _job(tracer, root, step, 0.05, **attrs)
    recs = [r for r in tracer.records(lo, hi) if r.name == step]
    assert len(recs) == 2
    want = sum(r.seconds for r in recs) / 2 * scale
    assert read(_trace_of(lo, hi)) == pytest.approx(want)
    assert 0.01 * scale <= want < 0.03 * scale
