"""The LCP tools: lcpbit, hwtToLCP, checkLCPBit.

Port of ``bwtb3m_tpu/cli/lcp_tools.py``, over ``lcp/``.  They keep the
reference package's arguments and add ``device=`` (default ``cuda``),
which the flag-style tools take from among their file arguments.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

from ..util.args import ArgInfo, ArgParser
from ..util.log import VerboseLog


def _device_arg(argv: List[str]) -> Tuple[List[str], str]:
    """(argv without ``device=...``, the device named, default cuda) for
    the tools that parse ``-flags``: a ``key=value`` that names no file
    is an option, as ``ArgInfo`` reads it."""
    rest, device = [], "cuda"
    for arg in argv:
        if arg.startswith("device=") and not os.path.exists(arg):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return rest, device


def lcpbit(argv: List[str]) -> int:
    """The succinct PLCP bit vector of a build's text (``-test`` runs the
    self-test harness)."""
    argv, device = _device_arg(argv)
    ap = ArgParser(argv)
    if ap.has("test"):
        from ..lcp.selftest import run_selftests
        return run_selftests(verbose=True, device=device)
    if len(ap.restargs) < 1:
        sys.stderr.write(
            "usage: lcpbit [-T<tmpprefix>] [-t<threads>] [device=cuda] "
            "<in.bwt> [out.lcpbit]\n       lcpbit -test [device=cuda]\n")
        return 1
    from ..lcp.plcp import compute_plcp_file
    bwt = ap.restargs[0]
    out = ap.restargs[1] if len(ap.restargs) > 1 else (
        (bwt[:-4] if bwt.endswith(".bwt") else bwt) + ".lcpbit")
    compute_plcp_file(bwt, out, device=device, log=VerboseLog(1))
    return 0


def hwt_to_lcp(argv: List[str]) -> int:
    """The plain .ulcp, the succinct .lcp and the RMQ .rmm tree of a
    build's LCP; ``checklcp=1`` cross-checks them."""
    ai = ArgInfo(argv, "hwtToLCP")
    if not ai.restargs:
        sys.stderr.write("usage: hwtToLCP [checklcp=0] [device=cuda] "
                         "<in.bwt>\n")
        return 1
    from ..lcp.wavelet_lcp import hwt_to_lcp_files
    return hwt_to_lcp_files(ai.restargs[0],
                            check=ai.get_bool("checklcp", False),
                            device=ai.get("device", "cuda"))


def check_lcp_bit(argv: List[str]) -> int:
    """Verify a .lcpbit against PLCP recomputed independently; prints
    ``lcpok=0|1`` and exits 1 on a mismatch."""
    argv, device = _device_arg(argv)
    ap = ArgParser(argv)
    if len(ap.restargs) < 2:
        sys.stderr.write("usage: checkLCPBit [device=cuda] <in.lcpbit> "
                         "<in.bwt>\n")
        return 1
    from ..lcp.plcp import verify_plcp_file
    ok = verify_plcp_file(ap.restargs[0], ap.restargs[1], device=device)
    print("lcpok=%d" % (1 if ok else 0))
    return 0 if ok else 1


TOOLS = {"lcpbit": lcpbit, "hwtToLCP": hwt_to_lcp,
         "checkLCPBit": check_lcp_bit}
