"""The plain reference of read alignment under Hamming distance: every
position of the indexed text (both strands, no terminator) where a read
or its reverse complement matches with at most ``maxmis`` substitutions,
as SAM records in the order and form that ``allHamDna`` states.

It finds candidates by the pigeonhole rule: cut a read into
``maxmis + 1`` disjoint parts; a match with at most ``maxmis``
substitutions matches one part exactly, so the 32-mer at the start of
that part occurs exactly.  Every text position's 32-mer is a 64-bit key,
sorted once; each read looks its parts' keys up and checks every
candidate position over the whole read.  Plain PyTorch on any device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

K = 32
BASES = "ACGT"


class KmerIndex:
    def __init__(self, text: torch.Tensor):
        """``text``: the indexed bases, codes 0..3 (int64 or uint8)."""
        t = text.to(torch.int64)
        self.text = text.to(torch.uint8)
        self.n = len(t)
        m = self.n - K + 1
        key = torch.zeros(m, dtype=torch.int64, device=t.device)
        for j in range(K):
            key = (key << 2) | t[j:j + m]
        self.keys, self.pos = torch.sort(key)

    def candidates(self, seeds: torch.Tensor):
        """(seed index, text position) of every exact occurrence of each
        32-mer key in ``seeds``."""
        lo = torch.searchsorted(self.keys, seeds, side="left")
        hi = torch.searchsorted(self.keys, seeds, side="right")
        cnt = hi - lo
        which = torch.repeat_interleave(
            torch.arange(len(seeds), device=seeds.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        at = lo[which] + torch.arange(len(which), device=seeds.device) \
            - first[which]
        return which, self.pos[at]


def _keys(pats: torch.Tensor, offs: List[int]) -> torch.Tensor:
    """The 32-mer keys of every pattern at each offset, [patterns, offs]."""
    out = []
    for o in offs:
        key = torch.zeros(len(pats), dtype=torch.int64, device=pats.device)
        for j in range(K):
            key = (key << 2) | pats[:, o + j]
        out.append(key)
    return torch.stack(out, 1)


def part_offsets(m: int, maxmis: int) -> List[int]:
    """The start of each of ``maxmis + 1`` disjoint parts of a read of
    ``m`` bases; each part holds at least 32 bases."""
    parts = maxmis + 1
    offs = [m * i // parts for i in range(parts)]
    ends = offs[1:] + [m]
    if any(e - o < K for o, e in zip(offs, ends)):
        raise ValueError("reads of %d bases are too short for %d parts of "
                         "%d" % (m, parts, K))
    return offs


def hits(index: KmerIndex, pats: torch.Tensor, maxmis: int):
    """Every (pattern, position, mismatches) with at most ``maxmis``
    mismatches, sorted by pattern, then position.  ``pats``: [P, m] codes
    0..3 of equal length m."""
    P, m = pats.shape
    offs = part_offsets(m, maxmis)
    keys = _keys(pats, offs)
    which, pos = index.candidates(keys.reshape(-1))
    pid = which // len(offs)
    start = pos - torch.tensor(offs, device=pats.device)[which % len(offs)]
    ok = (start >= 0) & (start + m <= index.n)
    pid, start = pid[ok], start[ok]
    # one candidate per (pattern, start)
    code = torch.unique(pid * index.n + start)
    pid, start = code // index.n, code % index.n
    mis = torch.zeros(len(pid), dtype=torch.int64, device=pats.device)
    for j in range(m):
        mis += (index.text[start + j].to(torch.int64) != pats[pid, j])
    keep = mis <= maxmis
    return pid[keep], start[keep], mis[keep]


def md_tag(ref: np.ndarray, read: np.ndarray) -> str:
    """MD:Z of an ungapped alignment: matched run lengths between the
    reference bases of the mismatches."""
    out, prev = [], 0
    for i in np.flatnonzero(ref != read).tolist():
        out.append("%d%s" % (i - prev, BASES[int(ref[i])]))
        prev = i + 1
    out.append(str(len(ref) - prev))
    return "".join(out)


def sam_records(index: KmerIndex, names: List[str], reads: np.ndarray,
                maxmis: int) -> Dict[str, List[str]]:
    """The SAM records of each read (name -> lines without newlines):
    for the read, then its reverse complement (flag 16), one record per
    matching position, by position, with NM and MD; an unmapped record
    (flag 4) when neither matches.  ``reads``: [R, m] codes 0..3."""
    dev = index.text.device
    fwd = torch.from_numpy(reads.astype(np.int64)).to(dev)
    rc = (3 - fwd).flip(1)
    pats = torch.stack([fwd, rc], 1).reshape(-1, reads.shape[1])
    pid, start, mis = hits(index, pats, maxmis)
    refs = index.text[start[:, None] + torch.arange(
        reads.shape[1], device=dev)].cpu().numpy()
    pid, start, mis = (x.cpu().numpy() for x in (pid, start, mis))
    m = reads.shape[1]
    bounds = np.searchsorted(pid, np.arange(len(pats) + 1))
    pats_np = pats.cpu().numpy()
    out = {}
    for r, name in enumerate(names):
        lines = []
        for strand in (0, 1):
            k = 2 * r + strand
            a, b = bounds[k], bounds[k + 1]
            if a == b:
                continue
            pat = pats_np[k]
            seq = "".join(BASES[c] for c in pat)
            for p, nm, ref in zip(start[a:b].tolist(), mis[a:b].tolist(),
                                  refs[a:b]):
                lines.append("%s\t%d\tref\t%d\t255\t%dM\t*\t0\t0\t%s\t*\t"
                             "NM:i:%d\tMD:Z:%s" % (name, 16 * strand, p + 1, m,
                                                   seq, nm, md_tag(ref, pat)))
        if not lines:
            seq = "".join(BASES[c] for c in reads[r])
            lines.append("%s\t4\t*\t0\t0\t*\t*\t0\t0\t%s\t*" % (name, seq))
        out[name] = lines
    return out
