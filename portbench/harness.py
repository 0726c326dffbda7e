"""The benchmark's driver: finds a cell's pieces by name, sets up, runs
the measured window, checks the outputs against the plain reference and
prints the result line.

Everything that belongs to one configuration, traffic mix, job kind or
per-layer metric lives in a file of its own that this module finds by
the name ``BENCHMARK.json`` gives it:

- ``BENCHMARK.json`` ``configs[].file``: the configuration (sizes, tool
  options, what was assumed);
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``job``
  names the job kind and whose other keys are that kind's parameters;
- ``portbench/jobs/<job>.py``: ``setup``, ``run``, ``release`` and
  ``check`` of a job kind, and the end-to-end metric it reports;
- ``portbench/layers/<metric>.py``: ``read(trace)`` of one per-layer
  metric, None where the run had nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BLOCKED = ("jax", "jaxlib", "flax", "bwtb3m_tpu")


class Refused(Exception):
    """A run that must print no result."""


def blocked_modules(modules=None) -> List[str]:
    """The top-level names in ``modules`` (``sys.modules``) that the
    benchmark must never load, compared whole: ``bwtb3m_tpu_torch`` is
    not ``bwtb3m_tpu``."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(BLOCKED))


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str, name: str) -> types.ModuleType:
    """The module in file ``path`` (its name may hold dots)."""
    if not os.path.exists(path):
        raise Refused("no such file: %s" % os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, cell: str):
    """(workload entry, configuration, traffic) of ``cell``."""
    work = [w for w in spec["workloads"] if w["name"] == cell]
    if not work:
        raise Refused("no workload named %r in BENCHMARK.json" % cell)
    work = work[0]
    conf = [c for c in spec["configs"] if c["name"] == work["config"]][0]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", work["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return work, config, traffic


def find_job(kind: str) -> types.ModuleType:
    return load_module(os.path.join(HERE, "jobs", kind + ".py"),
                       "portbench_job_" + kind)


def find_layer(metric: str) -> types.ModuleType:
    return load_module(os.path.join(HERE, "layers", metric + ".py"),
                       "portbench_layer_" + metric.replace(".", "_"))


def end_to_end_of(spec: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def run_window(job: Callable[[int], float], seconds: float,
               clock: Callable[[], float] = time.monotonic):
    """Run ``job(i)`` back to back until ``seconds`` have passed; the job
    in flight then finishes and counts.  Returns (jobs, work, wall s)."""
    t0 = clock()
    k, work = 0, 0.0
    while True:
        work += job(k)
        k += 1
        wall = clock() - t0
        if wall >= seconds:
            return k, work, wall


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def check_device(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused("the cell needs %d devices, %d present"
                      % (chips, torch.cuda.device_count()))


def run_cell(args, t_start: float, device: str = "cuda",
             out=sys.stdout, err=sys.stderr, spec: Optional[dict] = None
             ) -> int:
    """One run of a cell; prints the result line on ``out`` and returns
    the exit code.  ``device="cpu"`` (the tests) skips the look for a
    card and runs the program's plain versions; ``spec`` replaces
    ``BENCHMARK.json`` (the tests' small configurations)."""
    spec = spec or load_spec()
    work, config, traffic = find_cell(spec, args.workload)
    if device == "cuda":
        check_device(work["chips"])
    job = find_job(traffic["job"])
    tmp = tempfile.mkdtemp(prefix="portbench_", dir=tempfile.gettempdir())
    ctx = types.SimpleNamespace(
        config=config, traffic=traffic, seed=int(args.seed),
        seconds=args.seconds, trace=bool(args.trace), device=device, tmp=tmp,
        err=err, cell=args.workload)
    try:
        return _run(ctx, job, spec, work, t_start, out, err)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def io_counts() -> Dict[str, int]:
    """This process's I/O counters (``/proc/self/io``): ``wchar``, the
    bytes it passed to ``write``, and ``write_bytes``, those the kernel
    counted as sent to storage (0 where the filesystem does not count)."""
    return _proc_numbers("/proc/self/io", ("wchar", "write_bytes"))


def page_cache_mib() -> Dict[str, int]:
    """The machine's dirty and in-writeback page cache (``/proc/meminfo``,
    MiB): what earlier jobs wrote and the disk has not taken yet."""
    got = _proc_numbers("/proc/meminfo", ("Dirty", "Writeback"))
    return {k: v // 1024 for k, v in got.items()}


def _proc_numbers(path: str, keys) -> Dict[str, int]:
    got: Dict[str, int] = {}
    try:
        with open(path) as f:
            for line in f:
                key, _sep, value = line.partition(":")
                if key in keys:
                    got[key] = int(value.split()[0])
    except (OSError, ValueError, IndexError):
        pass
    return got


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _run(ctx, job, spec, work, t_start, out, err) -> int:
    import torch

    from .trace import WINDOW
    job.setup(ctx)
    _sync(ctx.device)
    # what set-up wrote (the text, an index) reaches the disk now, not
    # inside the window
    os.sync()
    setup_s = time.monotonic() - t_start
    err.write("[portbench] set-up %.3f s\n" % setup_s)
    failed = [0]

    def one(i: int) -> float:
        t0 = time.monotonic()
        try:
            work = job.run(ctx, i)
            err.write("[portbench] job %d: %.3f s, page cache %s\n"
                      % (i, time.monotonic() - t0, page_cache_mib()))
            return work
        except Exception as exc:        # a job that fails is counted
            import traceback
            traceback.print_exc(file=err)
            failed[0] += 1
            err.write("[portbench] job %d failed: %r\n" % (i, exc))
            return 0.0

    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if ctx.trace:
        if hasattr(job, "trace_start"):
            job.trace_start(ctx)
        # a job of many small launches (MANY_LAUNCHES) is profiled over
        # the window's second half only, as the profiler slows each
        # launch: its spans are read from the first half.  The profiler
        # records the card alone there (host events would double the
        # time to stop it), so its host annotations are its own spans
        many = getattr(job, "MANY_LAUNCHES", False)
        ctx.profile_host = not many
        share = 0.5 if many else 1.0
        first = (run_window(one, ctx.seconds * (1.0 - share))
                 if share < 1.0 else (0, 0.0, 0.0))
        _sync(ctx.device)
        spans = getattr(ctx, "spans", None)
        ctx.span_part = (types.SimpleNamespace(
            seconds=dict(spans.seconds), calls=dict(spans.calls),
            jobs=first[0], work=first[1], wall=first[2])
            if spans is not None and share < 1.0 else None)
        prof = torch.profiler.profile(activities=(
            [torch.profiler.ProfilerActivity.CPU]
            if ctx.profile_host or ctx.device != "cuda" else [])
            + [torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        w0 = time.time_ns()
        with torch.profiler.record_function(WINDOW):
            jobs, done, ctx.profiled_s = run_window(
                lambda i: one(first[0] + i), ctx.seconds * share)
            _sync(ctx.device)
        ctx.window_ns = (w0, time.time_ns())
        t_stop = time.monotonic()
        prof.__exit__(None, None, None)
        err.write("[portbench] profiler stop %.3f s\n"
                  % (time.monotonic() - t_stop))
        if hasattr(job, "trace_stop"):
            job.trace_stop(ctx)
        if share < 1.0:
            err.write("[portbench] unprofiled part: %d jobs in %.3f s; "
                      "profiled part: %d jobs in %.3f s\n"
                      % (first[0], first[2], jobs, ctx.profiled_s))
        jobs, done, wall = (first[0] + jobs, first[1] + done,
                            first[2] + ctx.profiled_s)
    else:
        jobs, done, wall = run_window(one, ctx.seconds)
        _sync(ctx.device)
    peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
            else 0)
    err.write("[portbench] window: %d jobs in %.3f s\n" % (jobs, wall))

    trace = None
    if ctx.trace:
        t_read = time.monotonic()
        trace = _read_trace(ctx, prof, wall, jobs, done, peak)
        del prof
        err.write("[portbench] trace read %.3f s\n"
                  % (time.monotonic() - t_read))
    job.release(ctx)
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    err.write("[portbench] bytes written: %s\n" % io_counts())
    t_check = time.monotonic()
    checks = job.check(ctx)
    err.write("[portbench] check %.3f s\n" % (time.monotonic() - t_check))
    correct = failed[0] == 0 and all(v <= lim for v, lim in checks.values())
    metrics: Dict[str, dict] = {}
    result = {"correct": bool(correct), "attempted": jobs,
              "failed": failed[0]}
    dev = (device_info(work["chips"]) if ctx.device == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 0})
    dev["memory_peak_bytes"] = int(peak)
    if ctx.trace:
        for m in per_layer_of(spec, ctx.cell):
            v = find_layer(m["name"]).read(trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    else:
        for m in end_to_end_of(spec, ctx.cell):
            v = (setup_s if m["name"] == "setup_s"
                 else job.end_to_end(ctx, m["name"], jobs, done, wall))
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # last of all, once the check and the readers have run: a run that
    # loaded JAX or the JAX package prints no result
    blocked = blocked_modules()
    if blocked:
        err.write("[portbench] refused: the run loaded %s\n"
                  % ", ".join(blocked))
        return 3
    for name, (v, lim) in checks.items():
        err.write("check %s = %s (limit %s)\n" % (name, v, lim))
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0


def _read_trace(ctx, prof, wall, jobs, done, peak):
    """The traced window as the per-layer readers see it."""
    from . import trace as tr
    dev, host = tr.split_events(tr.raw_events(prof))
    spans = getattr(ctx, "spans", None)
    if not ctx.profile_host:
        # the card alone was profiled: the window and the job's spans
        # on the host's clock, which the profiler's timestamps share
        host = [(ctx.window_ns[0], ctx.window_ns[1], tr.WINDOW)] + (
            list(spans.intervals) if spans is not None else [])
    lo, hi = tr.window_of(host)
    if dev:
        ctx.err.write("[portbench] trace clock: device events from %+.6f "
                      "to %+.6f s of the window's edges\n"
                      % ((min(s for s, _e, _n in dev) - lo) / 1e9,
                         (max(e for _s, e, _n in dev) - hi) / 1e9))
    dev = tr.clip(dev, lo, hi)
    busy = tr.union_ns(dev) / 1e9
    # the job's spans, over the jobs they were read from
    part = ctx.span_part or (types.SimpleNamespace(
        seconds=spans.seconds, calls=spans.calls, jobs=jobs, work=done,
        wall=wall) if spans is not None else None)
    t = types.SimpleNamespace(
        window_s=ctx.profiled_s, jobs=jobs, work=done, peak_bytes=peak,
        busy_s=busy, spans=part, device_ops=tr.top_ops(dev),
        idle_gaps=tr.idle_gaps(dev, host, lo, hi), job=ctx)
    ctx.err.write("[portbench] trace: %d device events, busy %.3f s of "
                  "%.3f s\n" % (len(dev), busy, ctx.profiled_s))
    return t
