"""The sampled SA / ISA tools: bwtcomputessa, hwtPreIsaToIsa, sortPreIsa,
sasubsample.

Port of ``bwtb3m_tpu/cli/ssa_tools.py``.  The first two walk on the
device (``device=``, default ``cuda``); the last two are host-only file
tools.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..io import formats
from ..util.args import ArgInfo, ArgParser
from ..util.log import VerboseLog


def bwtcomputessa(argv: List[str]) -> int:
    """Sampled SA + ISA from .bwt + .preisa without re-sorting.  The
    reference tool's tmpprefix=, copyinputtomemory=, threads=, maxsortmem=
    and maxtmpfiles= are accepted and ignored: the walk keeps everything
    in device memory."""
    from ..engine.ssa import compute_ssa

    ai = ArgInfo(argv, "bwtcomputessa")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwtcomputessa [sasamplingrate=32] [isasamplingrate=32] "
            "[ref_isa=..] [ref_sa=..] [device=cuda] <in.bwt>\n")
        return 1
    compute_ssa(
        ai.restargs[0],
        sa_sampling_rate=ai.get_int("sasamplingrate", 32),
        isa_sampling_rate=ai.get_int("isasamplingrate", 32),
        log=VerboseLog(ai.get_int("verbose", 1)),
        ref_isa=ai.get("ref_isa") or None,
        ref_sa=ai.get("ref_sa") or None,
        device=ai.get("device", "cuda"),
    )
    return 0


def hwt_preisa_to_isa(argv: List[str]) -> int:
    """.bwt + .preisa -> .isa at a chosen power-of-two rate (default
    64)."""
    from ..engine.ssa import compute_isa_from_preisa

    ai = ArgInfo(argv, "hwtPreIsaToIsa")
    if not ai.restargs:
        sys.stderr.write("usage: hwtPreIsaToIsa [isasamplingrate=64] "
                         "[device=cuda] <in.bwt>\n")
        return 1
    rate = ai.get_int("isasamplingrate", 64)
    if rate < 1 or rate & (rate - 1):
        sys.stderr.write("isasamplingrate must be a power of two\n")
        return 1
    compute_isa_from_preisa(ai.restargs[0], isa_sampling_rate=rate,
                            log=VerboseLog(ai.get_int("verbose", 1)),
                            device=ai.get("device", "cuda"))
    return 0


def sort_preisa(argv: List[str]) -> int:
    """Sort .preisa (rank, pos) pairs by position, verify strictly
    increasing positions, report the sampling-gap histogram, write the
    sorted pair file."""
    ai = ArgInfo(argv, "sortPreIsa")
    if not ai.restargs:
        sys.stderr.write("usage: sortPreIsa [outputfilename=..] <in.preisa>\n")
        return 1
    inp = ai.restargs[0]
    out = ai.get("outputfilename") or (inp + ".sorted")
    log = VerboseLog(ai.get_int("verbose", 1))
    ranks, poss, rate = formats.read_preisa(inp)
    order = np.argsort(poss, kind="stable")
    poss, ranks = poss[order], ranks[order]
    if len(poss) > 1 and (np.diff(poss) <= 0).any():
        log.e("positions are not strictly increasing after sort")
        return 1
    gaps = np.diff(poss)
    if len(gaps):
        uniq, cnt = np.unique(gaps, return_counts=True)
        for g, c in zip(uniq.tolist(), cnt.tolist()):
            log.v("gap[%d]=%d" % (g, c))
    formats.write_preisa(out, ranks, poss, rate or 0)
    log.v("wrote %s (%d pairs)" % (out, len(poss)))
    return 0


def sasubsample(argv: List[str]) -> int:
    """Subsample a sampled SA by a power-of-two factor -s: rate *= s,
    keep every s-th value."""
    ap = ArgParser(argv)
    s = ap.get_int("s", 1)
    if s < 1 or (s & (s - 1)):
        sys.stderr.write("sasubsample: -s must be a power of two >= 1\n")
        return 1
    if len(ap.restargs) < 2:
        sys.stderr.write("usage: sasubsample -s<factor> <in.sa> <out.sa>\n")
        return 1
    rate, values = formats.read_sampled_array(ap.restargs[0])
    formats.write_sampled_array(ap.restargs[1], rate * s, values[::s])
    return 0


TOOLS = {"bwtcomputessa": bwtcomputessa, "hwtPreIsaToIsa": hwt_preisa_to_isa,
         "sortPreIsa": sort_preisa, "sasubsample": sasubsample}
