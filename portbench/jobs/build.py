"""Builds of the configuration's genome, back to back: each one
``compute_bwt`` from the ``.pac`` on disk to the last file closed, into
an output directory of its own (its checkpoints there too), after the
program's result memos are cleared, as a fresh run of ``bwtb3m`` starts.
Reports ``build_msym_s``: input symbols of every build in the window per
second of the window.

Checked once the window has closed: every file of every build, byte for
byte (one number: the files wrong or missing), against what the plain reference writes from its own suffix array
(``.bwt``, ``.hist``, and with ``bwtonly=0`` ``.sa``, ``.isa``, ``.hwt``);
each ``.preisa`` by its pairs (any order).
"""

from __future__ import annotations

import os

import numpy as np

from portbench import program
from portbench.traffic import genome

METRIC = "build_msym_s"


def setup(ctx) -> None:
    ctx.pac = os.path.join(ctx.tmp, "genome.pac")
    ctx.forward = genome.write_pac(ctx.pac, ctx.config["genome"], ctx.seed)
    program.warm_up(ctx.config, ctx.traffic, ctx.seed, ctx.tmp, ctx.device)
    ctx.builds = []


def run(ctx, i: int) -> float:
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()
    out = program.fresh_dir(os.path.join(ctx.tmp, "build_%d" % i))
    log = program.SpanLog(annotate=ctx.trace)
    res = compute_bwt(program.build_options(ctx.config, ctx.pac, out,
                                            ctx.device), log=log)
    n = res.n
    del res
    ctx.builds.append({"dir": out, "phases": log.phases,
                       "spans": dict(log.spans)})
    top = sorted(list(log.phases.items()) + list(log.spans.items()),
                 key=lambda x: -x[1])[:8]
    ctx.err.write("[portbench] build %d: %s\n" % (i, ", ".join(
        "%s %.3f" % kv for kv in top)))
    return float(n)


def end_to_end(ctx, name: str, jobs: int, work: float, wall: float) -> float:
    return work / wall / 1e6


def trace_start(ctx) -> None:
    from bwtb3m_tpu_torch.ops import gapbatch, lf_walk

    from portbench import roofline, trace
    ctx.kernels = trace.KernelLog()
    ctx.undo = [ctx.kernels.wrap(gapbatch, "_launch", "chain",
                                 roofline.chain_work)]
    for attr in ("_launch", "_launch_w", "_launch_wm"):
        ctx.undo.append(ctx.kernels.wrap(lf_walk, attr, "lf_walk",
                                         roofline.lf_work))


def trace_stop(ctx) -> None:
    program.undo(ctx)


def release(ctx) -> None:
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()


def expected_files(text: np.ndarray, options: dict, device: str) -> dict:
    """What the reference writes for the pacterm ``text``: file
    extension -> bytes, and the ISA under ``"isa_full"`` for the
    ``.preisa`` check."""
    import torch

    from portbench.reference import files, sa as rsa
    t = torch.from_numpy(text).to(device)
    sa = rsa.suffix_array(t, 5)
    bwt = rsa.bwt_of(t, sa)
    out = {"bwt": files.rlb1_bytes(bwt, 5),
           "hist": files.hist_bytes(np.bincount(text, minlength=5))}
    isa = rsa.inverse(sa)
    if not int(options["bwtonly"]):
        srate = int(options["sasamplingrate"])
        irate = int(options["isasamplingrate"])
        out["sa"] = files.sampled_bytes(srate, sa[::srate])
        out["isa"] = files.sampled_bytes(irate, isa[::irate])
        out["hwt"] = files.hwt_bytes(bwt, 5)
    del sa, bwt, t
    out["isa_full"] = isa
    return out


def compare_build(out_dir: str, want: dict) -> dict:
    """For one build's directory: file extension -> 1 when the file is
    wrong or missing, else 0."""
    from portbench.reference import files
    got = {}
    for ext, data in want.items():
        if ext == "isa_full":
            continue
        path = os.path.join(out_dir, "genome." + ext)
        got[ext] = int(program.read_bytes(path) != data)
    base = os.path.join(out_dir, "genome.preisa")
    got["preisa"] = int(files.preisa_wrong(
        program.read_bytes(base), program.read_bytes(base + ".meta"),
        want["isa_full"]) > 0)
    return got


def check(ctx) -> dict:
    """One number, the wrong or missing files of the window's builds
    (limit 0); by extension on standard error."""
    text = genome.pacterm_symbols(ctx.forward)
    want = expected_files(text, ctx.config["options"], ctx.device)
    wrong = {ext: 0 for ext in want if ext != "isa_full"}
    wrong["preisa"] = 0
    for b in ctx.builds:
        for ext, bad in compare_build(b["dir"], want).items():
            wrong[ext] += bad
    ctx.err.write("[portbench] wrong files of %d builds: %s\n" % (
        len(ctx.builds), ", ".join("%s %d" % kv for kv in sorted(
            wrong.items()))))
    return {"files_wrong": (sum(wrong.values()), 0)}
