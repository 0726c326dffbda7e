"""The harness: the window's arithmetic, every piece found by its name,
the result line's shape, the import guard, and jobs that never find an
earlier job's files."""

from __future__ import annotations

import ast
import os

import pytest

from portbench import harness, program

ROOT = harness.ROOT


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("job_s,seconds,jobs", [
    (3.0, 10.0, 4), (2.5, 10.0, 4), (12.0, 10.0, 1), (1.0, 3.0, 3)])
def test_window_counts_the_job_in_flight(job_s, seconds, jobs):
    clock = FakeClock()

    def job(i):
        clock.t += job_s
        return 10.0

    k, work, wall = harness.run_window(job, seconds, clock=clock)
    assert k == jobs
    assert work == 10.0 * jobs
    assert wall == pytest.approx(job_s * jobs)
    assert wall >= seconds and wall - job_s < seconds


def test_every_piece_is_found_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        work, config, traffic = harness.find_cell(spec, w["name"])
        assert config["name"] == w["config"]
        job = harness.find_job(traffic["job"])
        for fn in ("setup", "run", "release", "check", "end_to_end"):
            assert callable(getattr(job, fn)), (traffic["job"], fn)
        e2e = {m["name"] for m in harness.end_to_end_of(spec, w["name"])}
        assert "setup_s" in e2e and job.METRIC in e2e
        assert harness.per_layer_of(spec, w["name"])
    for m in spec["per_layer"]:
        assert callable(harness.find_layer(m["name"]).read)
    with pytest.raises(harness.Refused):
        harness.find_cell(spec, "no.such.cell")
    with pytest.raises(harness.Refused):
        harness.find_layer("no.such.metric")


def test_per_layer_metrics_follow_their_cells():
    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                           {"name": "setup_s"}],
            "per_layer": [{"name": "p", "moves": "a", "workloads": ["y"]},
                          {"name": "q", "moves": "a"},
                          {"name": "r", "moves": "b"}]}
    assert [m["name"] for m in harness.per_layer_of(spec, "x")] == ["q"]
    assert [m["name"] for m in harness.per_layer_of(spec, "y")] == ["p"]


def test_import_guard_compares_whole_top_level_names():
    ok = ["bwtb3m_tpu_torch", "bwtb3m_tpu_torch.engine.api", "jax_like",
          "numpy", "flaxen"]
    assert harness.blocked_modules(ok) == []
    bad = ok + ["bwtb3m_tpu.engine", "jaxlib.xla_client", "jax", "flax.core"]
    assert harness.blocked_modules(bad) == ["bwtb3m_tpu", "flax", "jax",
                                            "jaxlib"]


@pytest.mark.parametrize("where", ["check", "layer"])
def test_a_run_that_loads_jax_after_the_window_prints_no_result(
        run_small, monkeypatch, where):
    """The guard looks at ``sys.modules`` after the check and the
    per-layer readers, the last code of a run before its result line."""
    import sys
    import types

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "check":
        find_job = harness.find_job

        def job_loading_jax(kind):
            job = find_job(kind)
            check = job.check
            wrapped = types.ModuleType(job.__name__)
            wrapped.__dict__.update(job.__dict__)

            def check_and_load(ctx):
                got = check(ctx)
                load_jax()
                return got

            wrapped.check = check_and_load
            return wrapped

        monkeypatch.setattr(harness, "find_job", job_loading_jax)
    else:
        find_layer = harness.find_layer

        def layer_loading_jax(metric):
            layer = find_layer(metric)

            def read(trace):
                load_jax()
                return layer.read(trace)

            return types.SimpleNamespace(read=read)

        monkeypatch.setattr(harness, "find_layer", layer_loading_jax)
    rc, res, err = run_small("chr21.build", seconds=0.05,
                             trace=int(where == "layer"))
    assert rc == 3 and res is None, err
    assert "refused: the run loaded jax" in err


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(ROOT, "portbench", sub)
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        names = set(_imports(path))
        assert not names & set(harness.BLOCKED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "bwtb3m_tpu_torch" not in names, path
        assert names <= {"__future__", "heapq", "struct", "typing", "numpy",
                         "torch"}, (path, names)


def test_a_job_never_finds_an_earlier_jobs_files(tmp_path):
    out = program.fresh_dir(str(tmp_path / "build_0"))
    # a checkpoint region an earlier build left
    open(os.path.join(out, "genome.bwt_tmp_BWTREG1_reg_1_0.npz"), "w").close()
    with pytest.raises(FileExistsError):
        program.fresh_dir(out)
    config = {"options": {"inputtype": "pacterm", "bwtonly": 1,
                          "sasamplingrate": 32, "isasamplingrate": 262144,
                          "mem": 1 << 31}}
    opts = program.build_options(config, "g.pac", str(tmp_path / "build_1"),
                                 "cpu")
    # outputs and checkpoints of a build live in its own directory
    assert opts.tmp_prefix.startswith(str(tmp_path / "build_1") + os.sep)
    assert opts.output_filename.startswith(str(tmp_path / "build_1") + os.sep)


def test_builds_in_one_window_use_fresh_directories(run_small):
    rc, res, err = run_small("chr21.build", seconds=0.3)
    assert rc == 0 and res["correct"], err
    assert res["attempted"] >= 2


def test_result_line_shape(run_small):
    rc, res, err = run_small("chr21.build", seconds=0.05)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert set(res["metrics"]) == {"build_msym_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert "check %s = " % name in err
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


@pytest.mark.parametrize("cell,layers,e2e", [
    ("grch38.build", {"merge.gt_bits_s", "merge.chain_anchor_s",
                      "io.bwt_write_s"}, "build_msym_s"),
    # a job that profiles the card alone: its spans still read
    ("chr21.align", {"index.load_s", "apps.search_ms_per_kread",
                     "apps.states_per_read"}, "align_reads_s")])
def test_traced_line_carries_per_layer_metrics(run_small, cell, layers, e2e):
    rc, res, err = run_small(cell, seconds=0.05, trace=1)
    assert rc == 0 and res["correct"], err
    assert layers <= set(res["metrics"])
    assert e2e not in res["metrics"]
    # the alignment's spans come from the part the profiler left alone
    assert ("unprofiled part" in err) == (cell == "chr21.align")
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_refuses_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.Refused):
        harness.check_device(1)
