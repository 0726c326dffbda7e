"""Fixtures of the benchmark's tests: the cells of ``BENCHMARK.json`` cut
to sizes the CPU runs in seconds (the program's plain versions), and the
``cuda`` marker for tests that need the card.

Run from the root of the repository:

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def small_config(name: str, forward: int, mem=None, exact_sd=False) -> dict:
    """A configuration of ``BENCHMARK.json`` at ``forward`` bases, its
    repeats cut to fit (duplications of 200-2,000 bases)."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        c = json.load(f)
    g = c["genome"]
    g["forward_bases"] = forward
    g["sd"]["copy_bases"] = [200, 2000]
    if exact_sd:
        g["sd"]["substitution"] = [0.0, 0.0]
    g["l1"]["copy_bases"] = [100, 1000]
    g["l1"]["consensus_bases"] = 1000
    if mem:
        c["options"]["mem"] = mem
    return c


@pytest.fixture(scope="session")
def small_spec(tmp_path_factory):
    """``BENCHMARK.json`` whose configurations and traffic are files of
    small sizes: 60,001 symbols in 3 blocks of the merge engine, 40,001
    in one block, 300 reads a call."""
    from portbench import harness
    d = tmp_path_factory.mktemp("spec")
    spec = copy.deepcopy(harness.load_spec())
    sizes = {"grch38-bwa-bounded": small_config(
        "grch38-bwa-bounded", 30000, mem=16 * 20001),
        "grch38-chr21-bwa": small_config("grch38-chr21-bwa", 20000)}
    for c in spec["configs"]:
        path = d / (c["name"] + ".json")
        path.write_text(json.dumps(sizes[c["name"]]))
        c["file"] = str(path)
    for w in spec["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")) as f:
            t = json.load(f)
        if "warmup_forward_bases" in t:
            t["warmup_forward_bases"] = 5000
        if "reads_per_call" in t:
            t["reads_per_call"] = 300
        path = d / (w["traffic"] + ".json")
        path.write_text(json.dumps(t))
        w["traffic"] = str(path)[:-len(".json")]
    return spec


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run_small(small_spec):
    """Run a cell of ``small_spec`` on the CPU through the harness (no
    look for a card); returns (exit code, result line or None, stderr)."""
    import io
    import time
    import types

    from portbench import harness

    def run(cell, seed=2 ** 31 + 11, seconds=0.05, trace=0):
        out, err = io.StringIO(), io.StringIO()
        args = types.SimpleNamespace(workload=cell, seed=seed,
                                     seconds=seconds, trace=trace)
        rc = harness.run_cell(args, time.monotonic(), device="cpu", out=out,
                              err=err, spec=small_spec)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

    return run
