"""Reads sampled from a genome, made from ``--seed``: each call of the
traffic gets its own file of ``reads_per_call`` reads of ``read_bases``
bases, from positions drawn uniformly over the forward strand, half of
them from the reverse strand, each base substituted with probability
``substitution`` (Illumina-like), as FASTA.
"""

from __future__ import annotations

import numpy as np

READS_STREAM = 2
BASES = np.frombuffer(b"ACGT", np.uint8)


def sample_reads(forward: np.ndarray, traffic: dict, seed: int, call: int):
    """(names, codes [R, m]) of call ``call``'s reads."""
    from .genome import mutate
    rng = np.random.default_rng([int(seed), READS_STREAM, int(call)])
    r = int(traffic["reads_per_call"])
    m = int(traffic["read_bases"])
    pos = rng.integers(0, len(forward) - m + 1, r)
    codes = forward[pos[:, None] + np.arange(m)]
    rev = rng.random(r) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    flat = codes.reshape(-1)
    mutate(rng, flat, np.float32(traffic["substitution"]))
    names = ["c%d_r%d" % (call, i) for i in range(r)]
    return names, flat.reshape(r, m)


def fasta_bytes(names, codes: np.ndarray) -> bytes:
    lines = []
    seqs = BASES[codes]
    for name, seq in zip(names, seqs):
        lines.append(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")
    return b"".join(lines)
