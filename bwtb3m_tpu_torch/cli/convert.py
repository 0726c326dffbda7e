"""The index-structure converters: bwttohwt, hwtToRlHwt, bwttodnarank,
bwttodnarank256, bwtb3mtobwa.

Port of five of the seven tools of ``bwtb3m_tpu/cli/convert.py``; all
five are host-only file tools, as there, and write the reference
package's bytes.  ``arraytocompact`` and ``fa4suffixarraytocompact`` come
with the compact-file tools (ROADMAP.md Queue 1 item 8c).
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

from ..index.bwa import rewrite as bwa_rewrite
from ..index.dnarank import DNARank
from ..index.wavelet import HuffmanWaveletTree, RLHuffmanWaveletTree
from ..io import formats
from ..io.rl import rl_decode
from ..util.args import ArgInfo
from ..util.log import VerboseLog


def _fresh(out: str, inp: str) -> bool:
    """Output exists and is at least as new as the input: the reference's
    freshness skip (checkbwt.cpp:46-53 .hwt mtime check; hwtToRlHwt.cpp:39
    recreate flag)."""
    return (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(inp))


def bwt_to_hwt(argv: List[str]) -> int:
    """.bwt -> .hwt Huffman wavelet tree (reference bwttohwt.cpp:35-40:
    symbol histogram then wavelet construction from the RL stream)."""
    ai = ArgInfo(argv, "bwttohwt")
    if not ai.restargs:
        sys.stderr.write("usage: bwttohwt [outputfilename=..] <in.bwt>\n")
        return 1
    inp = ai.restargs[0]
    out = ai.get("outputfilename") or (
        (inp[:-4] if inp.endswith(".bwt") else inp) + ".hwt")
    log = VerboseLog(ai.get_int("verbose", 1))
    if _fresh(out, inp) and not ai.get_bool("recreate", False):
        log.v("%s is up to date (recreate=1 to force)" % out)
        return 0
    bwt = rl_decode(inp)
    wt = HuffmanWaveletTree.build(bwt)
    wt.write(out)
    log.v("wrote %s (n=%d, %d symbols, %d nodes)"
          % (out, wt.n, len(wt.tree.symbols), len(wt.nodes)))
    return 0


def hwt_to_rlhwt(argv: List[str]) -> int:
    """.bwt + .hist -> .rlhwt run-length Huffman wavelet tree; verify=1
    re-reads the output and compares every symbol (reference
    hwtToRlHwt.cpp:89-265)."""
    ai = ArgInfo(argv, "hwtToRlHwt")
    if not ai.restargs:
        sys.stderr.write(
            "usage: hwtToRlHwt [verify=0] [outputfilename=..] <in.bwt>\n")
        return 1
    inp = ai.restargs[0]
    base = inp[:-4] if inp.endswith(".bwt") else inp
    out = ai.get("outputfilename") or (base + ".rlhwt")
    log = VerboseLog(ai.get_int("verbose", 1))
    if _fresh(out, inp) and not ai.get_bool("recreate", False):
        log.v("%s is up to date (recreate=1 to force)" % out)
        return 0
    bwt = rl_decode(inp)
    hist = None
    if os.path.exists(base + ".hist"):
        hist = formats.read_hist(base + ".hist")
    wt = RLHuffmanWaveletTree.build(bwt, hist=hist)
    wt.write(out)
    log.v("wrote %s" % out)
    if ai.get_bool("verify", False):
        back = RLHuffmanWaveletTree.read(out).decode_all()
        if not np.array_equal(back, bwt):
            log.e("verification FAILED")
            return 1
        log.v("verification ok (%d symbols)" % len(back))
    return 0


def _bwt_to_dnarank(argv: List[str], block: int) -> int:
    ai = ArgInfo(argv, "bwttodnarank")
    if not ai.restargs:
        sys.stderr.write("usage: bwttodnarank [outputfilename=..] <in.bwt>\n")
        return 1
    inp = ai.restargs[0]
    base = inp[:-4] if inp.endswith(".bwt") else inp
    out = ai.get("outputfilename") or (base + ".dnarank")
    dr = DNARank.from_run_length(inp, block=block)
    dr.write(out)
    VerboseLog(ai.get_int("verbose", 1)).v(
        "wrote %s (n=%d, block=%d)" % (out, dr.n, block))
    return 0


def bwt_to_dnarank(argv: List[str]) -> int:
    """4-symbol .bwt -> .dnarank with 64-aligned superblocks
    (reference bwttodnarank.cpp:34-36)."""
    return _bwt_to_dnarank(argv, 64)


def bwt_to_dnarank256(argv: List[str]) -> int:
    """Like bwttodnarank with 256-aligned superblocks
    (reference bwttodnarank256.cpp)."""
    return _bwt_to_dnarank(argv, 256)


def bwtb3m_to_bwa(argv: List[str]) -> int:
    """bwtb3m pacterm FM index -> BWA .bwt/.sa
    (reference bwtb3mtobwa.cpp:29)."""
    ai = ArgInfo(argv, "bwtb3mtobwa")
    if len(ai.restargs) < 3:
        sys.stderr.write("usage: bwtb3mtobwa <in.bwt> <out.bwt> <out.sa>\n")
        return 1
    bwa_rewrite(ai.restargs[0], ai.restargs[1], ai.restargs[2],
                verbose=ai.get_int("verbose", 1))
    return 0


TOOLS = {"bwttohwt": bwt_to_hwt, "hwtToRlHwt": hwt_to_rlhwt,
         "bwttodnarank": bwt_to_dnarank, "bwttodnarank256": bwt_to_dnarank256,
         "bwtb3mtobwa": bwtb3m_to_bwa}
