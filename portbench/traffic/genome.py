"""The genome text of a configuration, made from ``--seed``.

A forward strand of ``forward_bases`` bases stands in for human sequence
by its repeat content, as the configuration's ``genome`` group states it
(``gc``, ``alu``, ``l1``, ``sd``): i.i.d. background bases at the stated
GC share, copies of one Alu-like and one L1-like consensus at their
stated substitution rates and shares, and segmental duplications, copies
of the text itself.  Repeat copies take either orientation.  The text
that is indexed is the forward strand followed by its reverse complement,
as ``bwa fa2pac`` writes it, packed as a BWA ``.pac``.

Codes are A=0, C=1, G=2, T=3, so the complement of ``c`` is ``3 - c``.
Every number drawn comes from ``numpy.random.default_rng`` seeded with
``(seed, stream)``, so one seed gives one text on any machine.
"""

from __future__ import annotations

import numpy as np

GENOME_STREAM = 1


def random_bases(rng, n: int, gc: float) -> np.ndarray:
    """``n`` i.i.d. bases with P(C) = P(G) = gc / 2."""
    u = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    is_gc = (u & 0xFFFF) < np.uint32(round(gc * 65536))
    coin = ((u >> 16) & 1).astype(np.uint8)
    return np.where(is_gc, 1 + coin, 3 * coin).astype(np.uint8)


def mutate(rng, seq: np.ndarray, rate) -> np.ndarray:
    """``seq`` with each base replaced by another one with probability
    ``rate`` (a scalar or one rate per base), in place; returns it."""
    hit = rng.random(len(seq), dtype=np.float32) < rate
    k = int(hit.sum())
    seq[hit] = (seq[hit] + rng.integers(1, 4, k, dtype=np.uint8)) % 4
    return seq


def revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq[::-1]).astype(np.uint8)


def _copies(rng, consensus: np.ndarray, lengths: np.ndarray, lo: float,
            hi: float) -> np.ndarray:
    """5'-truncated copies of ``consensus`` (the last ``lengths[i]``
    bases), each at a substitution rate drawn from U(lo, hi), half of
    them reverse-complemented, concatenated."""
    m = len(consensus)
    total = int(lengths.sum())
    ends = np.cumsum(lengths)
    starts = ends - lengths
    # offset into the consensus of every base of every copy
    off = (np.arange(total, dtype=np.int64)
           - np.repeat(starts, lengths) + np.repeat(m - lengths, lengths))
    seq = consensus[off]
    rates = rng.uniform(lo, hi, len(lengths)).astype(np.float32)
    mutate(rng, seq, np.repeat(rates, lengths))
    flip = np.repeat(rng.random(len(lengths)) < 0.5, lengths)
    # a flipped copy reads its own bases backwards, complemented
    rev = np.repeat(starts + ends - 1, lengths) - np.arange(total)
    seq = np.where(flip, 3 - seq[np.where(flip, rev, 0)], seq)
    return seq.astype(np.uint8), starts, ends


def _split(seq: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    return [seq[a:b] for a, b in zip(starts.tolist(), ends.tolist())]


def forward_strand(genome: dict, seed: int):
    """(forward strand codes, bases per class) of the ``genome`` group of
    a configuration, from ``seed``."""
    rng = np.random.default_rng([int(seed), GENOME_STREAM])
    n = int(genome["forward_bases"])
    gc = float(genome["gc"])
    alu, l1, sd = genome["alu"], genome["l1"], genome["sd"]

    # Alu-like copies: the whole consensus
    alu_len = int(alu["consensus_bases"])
    n_alu = int(round(alu["share"] * n / alu_len))
    alu_seq, a0, a1 = _copies(rng, random_bases(rng, alu_len, gc),
                              np.full(n_alu, alu_len, np.int64),
                              *alu["substitution"])
    # L1-like copies: 5'-truncated to a length drawn uniformly
    l1_len = int(l1["consensus_bases"])
    lo, hi = l1["copy_bases"]
    want = l1["share"] * n
    lens = rng.integers(lo, hi + 1, int(want / ((lo + hi) / 2)) + 16)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), want)) + 1]
    lens[-1] -= max(0, int(lens.sum() - round(want)))
    lens = lens[lens > 0]
    l1_seq, b0, b1 = _copies(rng, random_bases(rng, l1_len, gc), lens,
                             *l1["substitution"])

    # segmental duplications: log-uniform lengths up to their share
    sd_total = int(round(sd["share"] * n))
    slo, shi = sd["copy_bases"]
    sd_lens = []
    while sum(sd_lens) < sd_total:
        sd_lens.append(int(np.exp(rng.uniform(np.log(slo), np.log(shi)))))
    sd_lens[-1] -= sum(sd_lens) - sd_total
    sd_lens = [x for x in sd_lens if x > 0]

    # phase 1: background pieces between the interspersed copies, in a
    # random order
    base_n = n - sd_total
    elems = _split(alu_seq, a0, a1) + _split(l1_seq, b0, b1)
    bg_n = base_n - len(alu_seq) - len(l1_seq)
    if bg_n < 0:
        raise ValueError("repeat shares exceed the genome")
    order = rng.permutation(len(elems))
    cuts = np.sort(rng.integers(0, bg_n + 1, len(elems)))
    bg = random_bases(rng, bg_n, gc)
    bounds = np.concatenate([[0], cuts, [bg_n]])
    parts = []
    for i, e in enumerate(order.tolist()):
        parts.append(bg[bounds[i]:bounds[i + 1]])
        parts.append(elems[e])
    parts.append(bg[bounds[-2]:bounds[-1]])
    text = np.concatenate(parts)
    del parts, elems, bg, alu_seq, l1_seq

    # phase 2: duplications of phase 1's text, inserted at random points
    src = rng.integers(0, base_n - shi, len(sd_lens))
    at = np.sort(rng.integers(0, base_n + 1, len(sd_lens)))
    parts, prev = [], 0
    for ln, s, a in zip(sd_lens, src.tolist(), at.tolist()):
        dup = mutate(rng, text[s:s + ln].copy(),
                     np.float32(rng.uniform(*sd["substitution"])))
        if rng.random() < 0.5:
            dup = revcomp(dup)
        parts += [text[prev:a], dup]
        prev = a
    parts.append(text[prev:])
    forward = np.concatenate(parts)
    assert len(forward) == n
    shares = {"alu": int(a1[-1]) if n_alu else 0, "l1": int(lens.sum()),
              "sd": sd_total,
              "background": bg_n}
    return forward, shares


def both_strands(forward: np.ndarray) -> np.ndarray:
    """The forward strand followed by its reverse complement."""
    return np.concatenate([forward, revcomp(forward)])


def pack_pac(codes: np.ndarray) -> bytes:
    """``codes`` as a BWA ``.pac``: four bases a byte, the first in the
    high bits; an extra zero byte when the length is a multiple of 4; a
    last byte holding the length mod 4."""
    n = len(codes)
    pad = np.zeros((-n) % 4, np.uint8)
    q = np.concatenate([codes, pad]).reshape(-1, 4)
    packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    tail = (b"\x00" if n % 4 == 0 else b"") + bytes([n % 4])
    return packed.astype(np.uint8).tobytes() + tail


def write_pac(path: str, genome: dict, seed: int) -> np.ndarray:
    """Write the text of ``genome`` from ``seed`` (both strands) as a
    ``.pac`` at ``path``; returns the forward strand."""
    forward, _shares = forward_strand(genome, seed)
    with open(path, "wb") as f:
        f.write(pack_pac(both_strands(forward)))
    return forward


def pacterm_symbols(forward: np.ndarray) -> np.ndarray:
    """The text that ``inputtype=pacterm`` indexes: both strands as
    symbols 1..4 and a terminator 0."""
    t = both_strands(forward)
    t += 1
    return np.concatenate([t, np.zeros(1, np.uint8)])
