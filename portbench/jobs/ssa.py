"""The bounded path's second step: set-up runs one ``bwtonly=1`` build
of the configuration's genome; each run is one ``compute_ssa`` from its
``.bwt`` and ``.preisa`` on disk (linked into a directory of the run's
own, where the run writes ``.sa`` and ``.isa``), at the configuration's
rates, with the result memos cleared first, as a fresh
``bwtcomputessa`` starts.  Reports ``ssa_msym_s``: text symbols per
second of the window.

Checked once the window has closed: every run's ``.sa`` and ``.isa``,
byte for byte, against the plain reference's samples of its own suffix
array.
"""

from __future__ import annotations

import os

from portbench import program
from portbench.traffic import genome

METRIC = "ssa_msym_s"
LINKED = ("bwt", "hist", "preisa", "preisa.meta", "meta")


def _rates(config: dict):
    return int(config["ssa"]["sasamplingrate"]), int(
        config["ssa"]["isasamplingrate"])


def _ssa(ctx, bwt_path: str, out_dir: str, log) -> str:
    """One ``compute_ssa`` of ``bwt_path``'s files into ``out_dir``."""
    from bwtb3m_tpu_torch.engine.ssa import compute_ssa
    base = bwt_path[:-len(".bwt")]
    for ext in LINKED:
        os.link(base + "." + ext, os.path.join(out_dir, "genome." + ext))
    sa_rate, isa_rate = _rates(ctx.config)
    compute_ssa(os.path.join(out_dir, "genome.bwt"), sa_rate, isa_rate,
                log=log, device=ctx.device)
    return out_dir


def setup(ctx) -> None:
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.result import clear_caches
    ctx.pac = os.path.join(ctx.tmp, "genome.pac")
    ctx.forward = genome.write_pac(ctx.pac, ctx.config["genome"], ctx.seed)

    def warm(bwt_path):
        _ssa(ctx, bwt_path, program.fresh_dir(os.path.join(ctx.tmp,
                                                           "warmup_ssa")),
             program.SpanLog())

    program.warm_up(ctx.config, ctx.traffic, ctx.seed, ctx.tmp, ctx.device,
                    then=warm)
    out = program.fresh_dir(os.path.join(ctx.tmp, "index"))
    res = compute_bwt(program.build_options(ctx.config, ctx.pac, out,
                                            ctx.device),
                      log=program.SpanLog())
    ctx.index_bwt = res.bwt_path
    ctx.n = res.n
    del res
    clear_caches()
    ctx.runs = []


def run(ctx, i: int) -> float:
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()
    out = program.fresh_dir(os.path.join(ctx.tmp, "ssa_%d" % i))
    log = program.SpanLog(annotate=ctx.trace)
    _ssa(ctx, ctx.index_bwt, out, log)
    ctx.runs.append({"dir": out, "spans": dict(log.spans)})
    return float(ctx.n)


def end_to_end(ctx, name: str, jobs: int, work: float, wall: float) -> float:
    return work / wall / 1e6


def trace_start(ctx) -> None:
    import torch
    from bwtb3m_tpu_torch.engine import result, ssa
    from bwtb3m_tpu_torch.io import formats
    from bwtb3m_tpu_torch.ops import lf_walk

    from portbench import roofline, trace
    # what the host does in a run, for the trace's idle gaps
    ctx.spans = trace.Spans(sync=torch.cuda.synchronize
                            if ctx.device == "cuda" else None)
    undo = [ctx.spans.wrap(result.BwtResult, "load_focc", "rank rows"),
            ctx.spans.wrap(result.BwtResult, "load_preisa", "read .preisa"),
            ctx.spans.wrap(ssa, "harvest_walk", "harvest walk"),
            ctx.spans.wrap(formats, "write_sampled_array", "write samples")]
    ctx.kernels = trace.KernelLog()
    ctx.undo = undo + [ctx.kernels.wrap(lf_walk, attr, "lf_walk",
                                        roofline.lf_work)
                       for attr in ("_launch", "_launch_w", "_launch_wm")]
    ctx.undo.append(ctx.kernels.wrap(lf_walk, "_launch_select", "lf_select",
                                     lambda *a, **k: (0.0, 0.0)))


def trace_stop(ctx) -> None:
    program.undo(ctx)


def release(ctx) -> None:
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()


def check(ctx) -> dict:
    import torch

    from portbench.reference import files, sa as rsa
    text = torch.from_numpy(genome.pacterm_symbols(ctx.forward)).to(
        ctx.device)
    sa = rsa.suffix_array(text, 5)
    del text
    sa_rate, isa_rate = _rates(ctx.config)
    want = {"sa": files.sampled_bytes(sa_rate, sa[::sa_rate])}
    isa = rsa.inverse(sa)
    del sa
    want["isa"] = files.sampled_bytes(isa_rate, isa[::isa_rate])
    del isa
    wrong = {"sa": 0, "isa": 0}
    for r in ctx.runs:
        for ext, data in want.items():
            got = program.read_bytes(os.path.join(r["dir"], "genome." + ext))
            wrong[ext] += int(got != data)
    ctx.err.write("[portbench] wrong files of %d runs: sa %d, isa %d\n"
                  % (len(ctx.runs), wrong["sa"], wrong["isa"]))
    return {"files_wrong": (wrong["sa"] + wrong["isa"], 0)}
