"""Read alignment against the configuration's index: set-up builds the
index once (its ``bwtonly=0`` files: ``.sa`` and ``.hwt`` beside the
``.bwt``), then each call is one ``all_ham_dna`` over a reads file of its
own, with the result memos cleared first, SAM written to a file.
Reports ``align_reads_s``: reads whose SAM record was written per
second of the window.

Checked once the window has closed: every record of every read of every
call against the plain reference's (``reference/align.py``), and each
call's header (one number: the reads and headers that differ).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

from portbench import program
from portbench.traffic import genome, reads

METRIC = "align_reads_s"
# the search launches ~143,000 kernels a call, which the profiler slows
# by a quarter: a traced run reads the spans from an unprofiled part
MANY_LAUNCHES = True
WARMUP_CALL = 1 << 30     # the reads of the warm-up call: no call of a window


def _write_reads(ctx, call: int) -> str:
    names, codes = reads.sample_reads(ctx.forward, ctx.traffic, ctx.seed,
                                      call)
    path = os.path.join(ctx.tmp, "reads_%d.fa" % call)
    with open(path, "wb") as f:
        f.write(reads.fasta_bytes(names, codes))
    return path


def _align(ctx, reads_path: str, sam_path: str) -> None:
    from bwtb3m_tpu_torch.apps.hamdna import all_ham_dna
    with open(sam_path, "w") as out:
        rc = all_ham_dna(ctx.index_bwt, reads_path,
                         maxmis=int(ctx.traffic["maxmis"]), out=out,
                         device=ctx.device)
    if rc != 0:
        raise RuntimeError("all_ham_dna returned %d" % rc)


def setup(ctx) -> None:
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.result import clear_caches
    ctx.pac = os.path.join(ctx.tmp, "genome.pac")
    ctx.forward = genome.write_pac(ctx.pac, ctx.config["genome"], ctx.seed)
    out = program.fresh_dir(os.path.join(ctx.tmp, "index"))
    res = compute_bwt(program.build_options(ctx.config, ctx.pac, out,
                                            ctx.device),
                      log=program.SpanLog())
    ctx.index_bwt = res.bwt_path
    del res
    clear_caches()
    # the search, locate and record paths once, on a call's worth of reads
    warm = _write_reads(ctx, WARMUP_CALL)
    t0 = time.monotonic()
    _align(ctx, warm, os.path.join(ctx.tmp, "warmup.sam"))
    warm_s = time.monotonic() - t0
    clear_caches()
    # the reads of the calls the window will hold, as the warm-up call's
    # time foretells them, with half again for calls that run faster
    # than the first; a call past them writes its reads in the window
    ctx.reads = [_write_reads(ctx, c) for c in range(
        int(1.5 * ctx.seconds / max(warm_s, 1e-3)) + 2)]
    ctx.err.write("[portbench] warm-up call %.3f s, %d reads files\n"
                  % (warm_s, len(ctx.reads)))
    ctx.calls = []


def run(ctx, i: int) -> float:
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()
    path = ctx.reads[i] if i < len(ctx.reads) else _write_reads(ctx, i)
    sam = os.path.join(ctx.tmp, "call_%d.sam" % i)
    _align(ctx, path, sam)
    ctx.calls.append((i, sam))
    return float(ctx.traffic["reads_per_call"])


def end_to_end(ctx, name: str, jobs: int, work: float, wall: float) -> float:
    return work / wall


def trace_start(ctx) -> None:
    import torch
    from bwtb3m_tpu_torch.apps import hamdna

    from portbench import trace
    hamdna.FRONTIER["max"] = hamdna.FRONTIER["stepped"] = 0
    ctx.spans = trace.Spans(sync=torch.cuda.synchronize
                            if ctx.device == "cuda" else None)
    ctx.undo = [ctx.spans.wrap(hamdna, "hamming_search_batch", "search"),
                ctx.spans.wrap(hamdna.FMIndex, "locate_batch", "locate")]
    for cls, attr in ((hamdna.BwtResult, "load"),
                      (hamdna.FMIndex, "from_bwt_result")):
        ctx.undo.append(_wrap_classmethod(ctx.spans, cls, attr, "index.load"))


def _wrap_classmethod(spans, cls, attr: str, name: str):
    desc = cls.__dict__.get(attr)
    if desc is None:
        return None
    bound = getattr(cls, attr)

    def timed(*args, **kw):
        with spans(name):
            return bound(*args, **kw)

    setattr(cls, attr, staticmethod(timed))
    return lambda: setattr(cls, attr, desc)


def trace_stop(ctx) -> None:
    from bwtb3m_tpu_torch.apps import hamdna
    ctx.stepped = hamdna.FRONTIER["stepped"]
    program.undo(ctx)


def release(ctx) -> None:
    from bwtb3m_tpu_torch.engine.result import clear_caches
    clear_caches()


def read_sam(path: str):
    """(header lines, read name -> its record lines in file order)."""
    head, recs = [], defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                head.append(line)
            elif line:
                recs[line.split("\t", 1)[0]].append(line)
    return head, recs


def expected_header(n_bases: int):
    return ["@HD\tVN:1.6\tSO:unknown", "@SQ\tSN:ref\tLN:%d" % n_bases,
            "@PG\tID:allHamDna\tPN:allHamDna"]


def check(ctx) -> dict:
    import torch

    from portbench.reference.align import KmerIndex, sam_records
    text = genome.both_strands(ctx.forward)
    index = KmerIndex(torch.from_numpy(text).to(ctx.device))
    head_want = expected_header(len(text))
    wrong_reads = wrong_heads = 0
    maxmis = int(ctx.traffic["maxmis"])
    for call, sam in ctx.calls:
        names, codes = reads.sample_reads(ctx.forward, ctx.traffic, ctx.seed,
                                          call)
        want = sam_records(index, names, codes, maxmis)
        head, got = read_sam(sam)
        wrong_heads += int(head != head_want)
        wrong_reads += sum(int(got.get(nm) != want[nm]) for nm in names)
        wrong_reads += len(set(got) - set(names))
    del index
    ctx.err.write("[portbench] %d calls: %d reads with wrong or missing "
                  "records, %d wrong headers\n"
                  % (len(ctx.calls), wrong_reads, wrong_heads))
    return {"sam_wrong": (wrong_reads + wrong_heads, 0)}
