"""The decoding tools: bwtb3mdecoderl and bwtdecodeblock.

Port of two tools of ``bwtb3m_tpu/cli/check.py`` (the port's checkbwt
stays in ``cli/__init__.py``).  ``bwtb3mdecoderl`` is host-only;
``bwtdecodeblock`` decodes through the FM index's ``extract`` on the
device (``device=``, default ``cuda``): one launch of the LF-walk
kernel's decode visit.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..io.inputtypes import parse_input_type
from ..io.rl import open_bwt
from ..util.args import ArgInfo


def bwtb3m_decode_rl(argv: List[str]) -> int:
    """Decode .bwt (RL) back to a byte stream on stdout
    (reference bwtb3mdecoderl.cpp:27-47 decodeRun loop)."""
    ai = ArgInfo(argv, "bwtb3mdecoderl")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwtb3mdecoderl [format=bytestream|utf-8] <in.bwt>\n")
        return 1
    fmt = ai.get("format", "bytestream")
    with open_bwt(ai.restargs[0]) as r:
        out = sys.stdout.buffer
        for b in range(r.nb):
            block = r.decode_block(b)
            if fmt == "utf-8":
                out.write("".join(chr(int(c)) for c in block).encode("utf-8"))
            else:
                out.write(block.astype(np.uint8).tobytes())
    return 0


def bwt_decode_block(argv: List[str]) -> int:
    """Random-access decode of text range [low, low+len) from the FM index
    files, asserting against the original input when given (reference
    bwtdecodeblock.cpp: SparseRank + LF walk back from the next ISA
    sample)."""
    from ..engine.result import BwtResult
    from ..index.fm import FMIndex

    ai = ArgInfo(argv, "bwtdecodeblock")
    if len(ai.restargs) < 3:
        sys.stderr.write(
            "usage: bwtdecodeblock [inputtype=..] [ref=<input>] "
            "[device=cuda] <in.bwt> <low> <len>\n")
        return 1
    bwt_path = ai.restargs[0]
    low = int(ai.restargs[1])
    length = int(ai.restargs[2])
    result = BwtResult.load(bwt_path)
    fm = FMIndex.from_bwt_result(result, structure="hwt",
                                 device=ai.get("device", "cuda"))
    if fm.isa is None:
        sys.stderr.write(
            "bwtdecodeblock: no .isa sidecar (run without bwtonly)\n")
        return 1
    out = fm.extract(low, length)
    if ai.has("ref"):
        itype = parse_input_type(ai.get("inputtype", "bytestream"))
        text, _sigma = itype.load(ai.get("ref"))
        expect = np.take(text, (low + np.arange(length)) % len(text))
        if not np.array_equal(out, expect):
            sys.stderr.write("bwtdecodeblock: MISMATCH vs reference input\n")
            return 1
    sys.stdout.buffer.write(out.astype(np.uint8).tobytes())
    return 0


TOOLS = {"bwtb3mdecoderl": bwtb3m_decode_rl, "bwtdecodeblock": bwt_decode_block}
