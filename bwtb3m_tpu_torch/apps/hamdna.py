"""allHamDna: all-mapper under Hamming distance.

Port of ``bwtb3m_tpu/apps/hamdna.py``.  The reference tool (upstream
src/allHamDna.cpp) loads a bidirectional DNA FM index, calls
``hammingSearchRecUnmapped(pat, maxmis, ...)`` per read (:158-163), maps
SA ranks to positions through the sampled SA (:182-183) and emits BAM
records with NM/MD tags (:198-253), searching the read and its reverse
complement.  The JAX package searches the FM index of the pacterm
reference with a depth-first branch-and-bound recursion over the 4-base
alphabet, one ``fm.step`` a node, locates each read's hits through the
sampled SA and writes SAM text or, with ``obam=``, BAM through its
``io/bam.py``.

Here the search is breadth-first on the card (``hamming_search_batch``):
at each depth every live state (pattern, lo, hi, mismatches) of a chunk
of reads, both strands, is extended by the four bases through one
``ops/lf.py::backward_search_step``, and states over ``maxmis`` or with an
empty interval are dropped.  A state's children follow it in base order,
so the frontier stays in the recursion's depth-first order and each
pattern's finished intervals come out as the recursion's list, in its
order.  All hits of a chunk are located together, one ``locate_batch``.
The SAM and BAM bytes equal the reference's.  The recursion itself, over
the plain ``rank``, is ``ops/lf.py::hamming_search_plain``.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine.result import BwtResult
from ..index.fm import FMIndex
from ..io.fasta import iter_fasta, iter_fastq
from ..ops.lf import backward_search_step
from ..util import trace
from ..util.log import VerboseLog

_MAP = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _MAP[ch] = i
    _MAP[ch + 32] = i
_BASES = "ACGT"
READ_CHUNK = 1024           # reads (two patterns each) searched together
# the breadth-first search's states stepped since the last reset (each a
# lane of backward_search_step)
FRONTIER = {"stepped": 0}


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def _base_ids(fm: FMIndex, shift: int) -> torch.Tensor:
    """The rows' dense ids of the four bases (-1 where absent)."""
    return fm.dense_ids(np.arange(4) + shift)


def _pattern_matrix(fm: FMIndex, patterns: Sequence[np.ndarray]):
    m = np.array([len(p) for p in patterns], dtype=np.int64)
    pat = np.zeros((len(patterns), max(1, int(m.max(initial=0)))), np.int64)
    for i, p in enumerate(patterns):
        pat[i, :len(p)] = p
    return (torch.from_numpy(pat).to(fm.device),
            torch.from_numpy(m).to(fm.device))


def hamming_search_batch(fm: FMIndex, patterns: Sequence[np.ndarray],
                         maxmis: int, shift: int = 1):
    """Breadth-first search of every pattern (2-bit codes; ``shift`` maps
    them onto the index alphabet: pacterm bases are {1..4}): the finished
    intervals as int64 tensors (pattern, lo, hi, nm), each pattern's in
    the order of the reference's recursion."""
    pat, m = _pattern_matrix(fm, patterns)
    dev = fm.device
    ids = _base_ids(fm, shift)
    C = fm._C_dense
    four = torch.arange(4, device=dev)
    p = torch.arange(len(patterns), device=dev)
    lo = torch.zeros_like(p)
    hi = torch.full_like(p, fm.n)
    nm = torch.zeros_like(p)
    live = hi > lo
    p, lo, hi, nm = p[live], lo[live], hi[live], nm[live]
    done = []
    t = 0
    while len(p):
        j = m[p] - 1 - t
        fin = j < 0
        if bool(fin.any()):
            done.append((p[fin], lo[fin], hi[fin], nm[fin]))
            keep = ~fin
            p, lo, hi, nm, j = p[keep], lo[keep], hi[keep], nm[keep], j[keep]
            if not len(p):
                break
        # children in base order after their parent: the frontier keeps
        # the recursion's order
        want = pat[p, j]
        nm4 = (nm[:, None] + (four[None, :] != want[:, None])).reshape(-1)
        c4 = four.repeat(len(p))
        ok = (nm4 <= maxmis) & (ids[c4] >= 0)
        idx = torch.nonzero(ok).squeeze(1)
        par = idx // 4
        d = ids[c4[idx]]
        FRONTIER["stepped"] += len(idx)
        l2, h2 = backward_search_step(fm.rows, d, lo[par], hi[par], C)
        keep = h2 > l2
        p, lo, hi, nm = p[par][keep], l2[keep], h2[keep], nm4[idx][keep]
        t += 1
    if not done:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z, z
    cols = [torch.cat(c) for c in zip(*done)]
    order = torch.sort(cols[0], stable=True).indices
    return tuple(c[order] for c in cols)


def hamming_search(fm: FMIndex, pattern: np.ndarray, maxmis: int,
                   shift: int = 1) -> List[Tuple[int, int, int]]:
    """The (lo, hi, nm) intervals of rotations matching ``pattern`` with
    at most ``maxmis`` mismatches, in the order of the reference's
    recursion (``hammingSearchRecUnmapped`` semantics), by the
    breadth-first search on ``fm``'s device."""
    _p, lo, hi, nm = hamming_search_batch(fm, [np.asarray(pattern)],
                                          maxmis, shift)
    return [tuple(int(v) for v in x)
            for x in zip(lo.tolist(), hi.tolist(), nm.tolist())]


def _md_and_nm(ref_codes: np.ndarray, read_codes: np.ndarray
               ) -> Tuple[str, int]:
    """MD:Z tag + NM for an ungapped alignment (the reference computes
    MD/NM at allHamDna.cpp:198-253)."""
    mis = np.flatnonzero(ref_codes != read_codes)
    md, prev = [], 0
    for i in mis:
        rc = int(ref_codes[i])
        md.append(str(i - prev))
        md.append(_BASES[rc] if 0 <= rc <= 3 else "N")
        prev = i + 1
    md.append(str(len(ref_codes) - prev))
    return "".join(md), len(mis)


def all_ham_dna(bwt_path: str, reads_path: str, maxmis: int = 2,
                out=None, bam_path: str = None, device="cuda") -> int:
    """When ``bam_path`` is given, emit BAM (the reference's output format,
    allHamDna.cpp:198-253, via io/bam.py); otherwise SAM text to ``out``.
    One ``apps.align`` span of the tracer, with the reads parsed as its
    ``reads``; under it ``apps.load`` and, for each chunk of reads,
    ``apps.search``, ``apps.locate`` and ``apps.emit`` (the parse is the
    root's own time); the closing log line gives each step's seconds."""
    log = VerboseLog(1)
    with trace.span("apps.align") as align:
        rc = _all_ham_dna(align, log, bwt_path, reads_path, maxmis,
                          out or sys.stdout, bam_path, device)
    if rc == 0:
        steps = dict.fromkeys(("apps.load", "apps.search", "apps.locate",
                               "apps.emit"), 0)
        for r in trace.records(align.start_ns, align.end_ns):
            if r.parent == align.id:
                steps[r.name] += r.ns
        log.v("allHamDna: load %.3fs, search %.3fs, locate %.3fs, emit "
              "%.3fs, parse and the rest %.3fs"
              % tuple(v / 1e9 for v in (*steps.values(),
                                        trace.self_ns(align))))
    return rc


def _all_ham_dna(align, log, bwt_path, reads_path, maxmis, out, bam_path,
                 device) -> int:
    from ..io.pac import read_pac
    with trace.span("apps.load"):
        result = BwtResult.load(bwt_path)
        if result.sigma != 5:
            log.e("allHamDna expects a pacterm index (sigma=5)")
            return 1
        fm = FMIndex.from_bwt_result(result, structure="hwt", device=device)
        if fm.sa is None:
            log.e("no sampled SA: rebuild without bwtonly or run "
                  "bwtcomputessa")
            return 1
        # reference text codes {0..3} for MD tags
        ref_codes = read_pac(result.meta["input"])
    ref_len = result.n - 1  # excluding terminator

    header = ("@HD\tVN:1.6\tSO:unknown\n"
              "@SQ\tSN:ref\tLN:%d\n"
              "@PG\tID:allHamDna\tPN:allHamDna\n" % ref_len)
    bam = None
    if bam_path is not None:
        from ..io.bam import BamWriter
        bam_fh = open(bam_path, "wb")
        bam = BamWriter(bam_fh, [("ref", ref_len)], header)
    else:
        out.write(header)

    def emit(name, flag, pos, m, read_str, nm, md):
        """One ungapped alignment (pos 0-based) or, with pos < 0, an
        unmapped record."""
        if bam is not None:
            if pos < 0:
                bam.write_record(name, 4, -1, -1, 0, [], read_str)
            else:
                bam.write_record(name, flag, 0, pos, 255, [(m, "M")],
                                 read_str, tags={"NM": nm, "MD": md})
            return
        if pos < 0:
            out.write("%s\t4\t*\t0\t0\t*\t*\t0\t0\t%s\t*\n" % (name, read_str))
        else:
            out.write(
                "%s\t%d\tref\t%d\t255\t%dM\t*\t0\t0\t%s\t*\tNM:i:%d\tMD:Z:%s\n"
                % (name, flag, pos + 1, m, read_str, nm, md))

    def reads():
        if reads_path.endswith((".fq", ".fastq", ".fq.gz", ".fastq.gz")):
            for name, seq, _q in iter_fastq(reads_path):
                yield name, seq
        else:
            yield from iter_fasta(reads_path)

    nreads = nhits = 0
    chunk = []

    def flush():
        nonlocal nhits
        pats = [x for _n, _s, codes in chunk
                for x in (codes, _revcomp(codes))]
        with trace.span("apps.search"):
            pid, lo, hi, _nm = hamming_search_batch(fm, pats, maxmis)
            lo, hi, pid = (lo.cpu().numpy(), hi.cpu().numpy(),
                           pid.cpu().numpy())
        with trace.span("apps.locate"):
            cnt = hi - lo
            ranks = np.repeat(lo - np.cumsum(np.r_[0, cnt[:-1]]), cnt) \
                + np.arange(int(cnt.sum()), dtype=np.int64)
            positions = fm.locate_batch(ranks)  # all hits walk together
        with trace.span("apps.emit"):
            hit_pid = np.repeat(pid, cnt)
            order = np.lexsort((positions, hit_pid))
            hit_pid, positions = hit_pid[order], positions[order]
            bounds = np.searchsorted(hit_pid, np.arange(len(pats) + 1))
            for r, (name, seq, codes) in enumerate(chunk):
                m = len(codes)
                found = False
                for strand in (0, 1):
                    k = 2 * r + strand
                    pat = pats[k]
                    ps = positions[bounds[k]:bounds[k + 1]]
                    if not len(ps):
                        continue
                    read_str = "".join(_BASES[int(c)] for c in pat)
                    for pos in ps.tolist():
                        if pos + m > ref_len:  # spans the terminator
                            continue
                        md, nm = _md_and_nm(ref_codes[pos:pos + m], pat)
                        emit(name, 16 * strand, pos, m, read_str, nm, md)
                        nhits += 1
                        found = True
                if not found:
                    emit(name, 4, -1, m, seq.decode(), 0, "")
        chunk.clear()

    for name, seq in reads():
        nreads += 1
        codes = _MAP[np.frombuffer(seq, dtype=np.uint8)].astype(np.int64)
        if (codes < 0).any():
            continue
        chunk.append((name, seq, codes))
        if len(chunk) == READ_CHUNK:
            flush()
    if chunk:
        flush()
    if bam is not None:
        bam.close()
        bam_fh.close()
    align.attrs["reads"] = nreads
    log.v("allHamDna: %d reads, %d alignments" % (nreads, nhits))
    return 0
