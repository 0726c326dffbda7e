"""CLI: ``python -m bwtb3m_tpu_torch <tool> [key=value ...] args``.

The ported tools keep the reference package's argument surface and add
``device=`` (default ``cuda``):

    bwtb3m          build .bwt/.hist/.preisa/.meta (+ .sa/.isa/.hwt)
    checkbwt        verify a build against its input, prints gok=0|1
    bwtcomputessa   sampled .sa/.isa from .bwt + .preisa
    hwtPreIsaToIsa  .isa at a chosen rate from .bwt + .preisa
    sortPreIsa      sort a .preisa by position (host only)
    sasubsample     thin a sampled .sa by a power of two (host only)
    lcpbit          the succinct PLCP bit vector (.lcpbit) of a build
    hwtToLCP        the .ulcp, .lcp and .rmm files of a build's LCP
    checkLCPBit     verify a .lcpbit, prints lcpok=0|1
    bwttestdecodespeed  LF-step throughput of batched walks
    bwtdecodeblock  decode a text range through the FM index (the LF-walk
                    kernel's decode visit)
    probeScanDna    k-mer abundance of probes (occ/hwt/rlhwt: one batched
                    backward search on the device; words: host)
    allHamDna       all-mapper under Hamming distance, SAM or BAM (the
                    search breadth-first on the device, the hits through
                    the LF-walk kernel's locate visit)
    bwttohwt, hwtToRlHwt, bwttodnarank, bwttodnarank256, bwtb3mtobwa,
    bwtb3mdecoderl  index files and the RL decoder (host only)
    arraytocompact, fa4suffixarraytocompact  sampled arrays and SA
                    coordinates as compact arrays (host only)
    fagzToCompact, fagzToCompact4, fagzToCompactUTerm,
    fagzToCompact4BigBand, fagzToCompact4BigBandBiDir, digitsToCompact,
    decodecompact, bytestreamToLz4  input preparation (host only)

(the sampled-SA tools live in ``cli/ssa_tools.py``, the LCP tools in
``cli/lcp_tools.py``, the speed tool in ``cli/speed.py``, the converters
in ``cli/convert.py``, the decoders in ``cli/check.py``, the
applications in ``cli/apps.py`` and the input-preparation tools in
``cli/prep.py``, as in the reference).  These are all 29 tools of the
reference package.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from . import apps, check, convert, lcp_tools, prep, speed, ssa_tools
from ..io.inputtypes import parse_input_type
from ..util.args import ArgInfo
from ..util.log import VerboseLog


def checkbwt(argv: List[str]) -> int:
    """LF-walk the whole text backwards and compare every symbol with the
    input; prints ``gok=1`` on success, exits 1 on a mismatch."""
    from ..engine.result import BwtResult
    from ..engine.verify import check_bwt

    ai = ArgInfo(argv, "checkbwt")
    if len(ai.restargs) < 2:
        sys.stderr.write("usage: checkbwt inputtype=<type> [device=cuda] "
                         "<input> <in.bwt>\n")
        return 1
    itype = parse_input_type(ai.get("inputtype", "bytestream"))
    text, _sigma = itype.load(ai.restargs[0])
    result = BwtResult.load(ai.restargs[1])
    log = VerboseLog(ai.get_int("verbose", 1))
    ok = check_bwt(result, np.asarray(text), device=ai.get("device", "cuda"),
                   log=log)
    print("gok=%d" % (1 if ok else 0))
    return 0 if ok else 1


def bwtb3m(argv: List[str]) -> int:
    from ..engine.api import main_bwtb3m
    return main_bwtb3m(argv)


TOOLS = {"bwtb3m": bwtb3m, "checkbwt": checkbwt, **ssa_tools.TOOLS,
         **lcp_tools.TOOLS, **speed.TOOLS, **convert.TOOLS, **check.TOOLS,
         **apps.TOOLS, **prep.TOOLS}


def dispatch(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help", "help"):
        sys.stderr.write(
            "usage: python -m bwtb3m_tpu_torch <tool> [args...]\ntools:\n  "
            + "\n  ".join(sorted(TOOLS)) + "\n")
        return 1
    name = argv[0]
    if name not in TOOLS:
        sys.stderr.write("unknown tool %r; try 'help'\n" % name)
        return 1
    return TOOLS[name](argv[1:]) or 0
