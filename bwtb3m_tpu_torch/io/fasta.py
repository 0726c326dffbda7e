"""FASTA / FASTQ streaming readers (plain or gzip).

Behavioural analog of the reference's ``fastx::StreamFastAReader`` /
``StreamFastQReader`` over ``lz::BufferedGzipStream``
(upstream src/fagzToCompact.cpp:21-22,107).
"""

from __future__ import annotations

import gzip
from typing import Iterator, Tuple


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (header, sequence bytes) per FASTA record."""
    name = None
    chunks = []
    with _open_maybe_gzip(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].decode("utf-8", "replace")
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def iter_fastq(path: str) -> Iterator[Tuple[str, bytes, bytes]]:
    """Yield (header, sequence, quality) per FASTQ record."""
    with _open_maybe_gzip(path) as f:
        while True:
            h = f.readline().strip()
            if not h:
                return
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            yield h[1:].decode("utf-8", "replace"), seq, qual


# DNA mapping used across the suite (reference ``fastx::acgtnMap`` role).
ACGT_TO_CODE = {65: 0, 67: 1, 71: 2, 84: 3,  # A C G T
                97: 0, 99: 1, 103: 2, 116: 3}  # a c g t


def reverse_complement_codes(codes):
    """Reverse complement for 2-bit codes (A<->T, C<->G)."""
    import numpy as np
    return (3 - np.asarray(codes))[::-1]
