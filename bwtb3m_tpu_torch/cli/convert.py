"""The index-structure converters: bwttohwt, hwtToRlHwt, bwttodnarank,
bwttodnarank256, bwtb3mtobwa, arraytocompact, fa4suffixarraytocompact.

Port of ``bwtb3m_tpu/cli/convert.py``; all seven are host-only file
tools, as there, and write the reference package's bytes.
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

from ..index.bwa import rewrite as bwa_rewrite
from ..index.dnarank import DNARank
from ..index.wavelet import HuffmanWaveletTree, RLHuffmanWaveletTree
from ..io import compact, formats
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


def array_to_compact(argv: List[str]) -> int:
    """.sa/.isa (sampled u64 array file) -> minimal-width compact array;
    two passes (max scan, then write) and a full read-back check
    (upstream arraytocompact.cpp:44-127)."""
    ai = ArgInfo(argv, "arraytocompact")
    if not ai.restargs:
        sys.stderr.write("usage: arraytocompact [outputfilename=..] <in.sa>\n")
        return 1
    inp = ai.restargs[0]
    out = ai.get("outputfilename") or (inp + ".compact")
    log = VerboseLog(ai.get_int("verbose", 1))
    _rate, values = formats.read_sampled_array(inp)
    maxv = int(values.max()) if len(values) else 0
    bits = max(1, int(maxv).bit_length())
    compact.write_compact(out, values, bits)
    back, rbits = compact.read_compact(out)
    if rbits != bits or not np.array_equal(back, values):
        log.e("verification FAILED")
        return 1
    log.v("wrote %s (%d values, %d bits) — verified" % (out, len(values), bits))
    return 0


def fa4_suffixarray_to_compact(argv: List[str]) -> int:
    """Sampled SA -> compact array of (sequence, offset) coordinates,
    ``seq << obits | offset``, from the sequence lengths in a
    fagzToCompact4 ``.meta`` (obits: the bits of the longest sequence's
    last offset); a position past the packed text maps to (nseq, 0).
    Verified by read-back (upstream fa4suffixarraytocompact.cpp:43-114)."""
    from .prep import read_compact4_meta

    ai = ArgInfo(argv, "fa4suffixarraytocompact")
    if len(ai.restargs) < 2:
        sys.stderr.write(
            "usage: fa4suffixarraytocompact [outputfilename=..] <in.sa> "
            "<compact4.meta>\n")
        return 1
    sa_path, meta_path = ai.restargs[0], ai.restargs[1]
    out = ai.get("outputfilename") or (sa_path + ".fa4compact")
    log = VerboseLog(ai.get_int("verbose", 1))
    _rate, values = formats.read_sampled_array(sa_path)
    lens = np.array([s for s, _ in read_compact4_meta(meta_path)],
                    dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    total = int(starts[-1])
    maxlen = int(lens.max()) if len(lens) else 1
    obits = max(1, (maxlen - 1).bit_length() if maxlen > 1 else 1)
    seq_idx = np.clip(np.searchsorted(starts, values, side="right") - 1,
                      0, len(lens))
    inside = values < total
    off = np.where(inside,
                   values - starts[np.clip(seq_idx, 0, len(lens) - 1)], 0)
    seq_out = np.where(inside, seq_idx, len(lens))
    coords = (seq_out.astype(np.int64) << obits) | off.astype(np.int64)
    bits = max(1, int(coords.max()).bit_length() if len(coords) else 1)
    compact.write_compact(out, coords, bits)
    back, _ = compact.read_compact(out)
    if not np.array_equal(back, coords):
        log.e("verification FAILED")
        return 1
    log.v("wrote %s (%d coords, obits=%d) — verified"
          % (out, len(coords), obits))
    return 0


TOOLS = {"bwttohwt": bwt_to_hwt, "hwtToRlHwt": hwt_to_rlhwt,
         "bwttodnarank": bwt_to_dnarank, "bwttodnarank256": bwt_to_dnarank256,
         "bwtb3mtobwa": bwtb3m_to_bwa, "arraytocompact": array_to_compact,
         "fa4suffixarraytocompact": fa4_suffixarray_to_compact}
