"""The applications: probeScanDna and allHamDna.

Port of ``bwtb3m_tpu/cli/apps.py``.  Both run on the device
(``device=``, default ``cuda``): probeScanDna's occ, hwt and rlhwt modes
as one batched backward search, allHamDna's search breadth-first; the
words mode of probeScanDna is host code.
"""

from __future__ import annotations

import sys
from typing import List

from ..util.args import ArgInfo


def probe_scan_dna(argv: List[str]) -> int:
    """k-mer abundance of query probes against a reference index
    (reference probeScanDna.cpp; occ/hwt/rlhwt modes use backward search,
    words mode a packed k-mer sort)."""
    ai = ArgInfo(argv, "probeScanDna")
    if len(ai.restargs) < 2:
        sys.stderr.write(
            "usage: probeScanDna [mode=occ|hwt|rlhwt|words] [k=31] "
            "[device=cuda] <ref.bwt|ref.compact4> <probes.fa>\n")
        return 1
    from ..apps.probescan import probe_scan
    return probe_scan(ai.restargs[0], ai.restargs[1],
                      mode=ai.get("mode", "hwt"), k=ai.get_int("k", 31),
                      device=ai.get("device", "cuda"))


def all_ham_dna(argv: List[str]) -> int:
    """All-mapper under Hamming distance over the FM index, emitting
    alignments (reference allHamDna.cpp:158-253)."""
    ai = ArgInfo(argv, "allHamDna")
    if len(ai.restargs) < 2:
        sys.stderr.write(
            "usage: allHamDna [maxmis=2] [obam=out.bam] [device=cuda] "
            "<ref-pacterm.bwt> <reads.fa|.fq>\n")
        return 1
    from ..apps.hamdna import all_ham_dna as run
    return run(ai.restargs[0], ai.restargs[1],
               maxmis=ai.get_int("maxmis", 2),
               bam_path=ai.get("obam", None) or None,
               device=ai.get("device", "cuda"))


TOOLS = {"probeScanDna": probe_scan_dna, "allHamDna": all_ham_dna}
