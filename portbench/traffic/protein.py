"""The protein text of a configuration, made from ``--seed``.

A text of ``text_bytes`` bytes stands in for the Pizza&Chili ``proteins``
file (Swiss-Prot sequences, one a line) by the statistics the
configuration's ``text`` group states: residues drawn i.i.d. at the
stated composition (the 20 amino acids and the rare codes), sequence
lengths log-normal and clipped, one ``\\n`` after each sequence, and
homology: a share of the sequences copy an earlier sequence with a
per-residue substitution rate drawn uniformly, and a share copy one
exactly.  A copy takes its source's length; the source is drawn
uniformly among the sequences before it, so copies of copies occur.  The
last sequence is cut where the text ends; ``bytestream`` reads the text
circularly.

Every number drawn comes from ``numpy.random.default_rng`` seeded with
``(seed, stream)``, so one seed gives one text on any machine.
"""

from __future__ import annotations

import math

import numpy as np

PROTEIN_STREAM = 3
TABLE_BITS = 20           # residues come from a table of 2^20 cells
COPY_CHUNK = 1 << 24      # copied positions gathered at a time


def residue_table(composition: dict) -> np.ndarray:
    """A table of 2^TABLE_BITS residue bytes in which each residue takes
    cells in proportion to its share (the shares normalised to 1; at
    least one cell each)."""
    codes = sorted(composition)
    share = np.array([float(composition[c]) for c in codes], np.float64)
    cells = np.maximum(1, np.round(share / share.sum()
                                   * (1 << TABLE_BITS))).astype(np.int64)
    cells[int(np.argmax(cells))] += (1 << TABLE_BITS) - int(cells.sum())
    return np.repeat(np.frombuffer("".join(codes).encode(), np.uint8), cells)


def composition_of(text_group: dict) -> dict:
    """Residue code -> share: the amino acids and the rare codes."""
    got = dict(text_group["composition"])
    got.update(text_group["rare"])
    return got


def _lengths(rng, count: int, length: dict) -> np.ndarray:
    med, sig = float(length["median"]), float(length["sigma"])
    lo, hi = int(length["min"]), int(length["max"])
    raw = rng.lognormal(math.log(med), sig, count)
    return np.clip(np.round(raw), lo, hi).astype(np.int64)


def _plan(rng, count: int, text_group: dict):
    """(kind, source, length) of ``count`` sequences: kind 0 fresh, 1 a
    homologous copy, 2 an exact copy; a copy's source is an earlier
    sequence and its length the source's."""
    hom = float(text_group["homolog"]["share"])
    exact = float(text_group["exact"]["share"])
    u = rng.random(count)
    kind = np.where(u < exact, 2, np.where(u < exact + hom, 1, 0))
    kind[0] = 0
    idx = np.arange(count, dtype=np.int64)
    src = np.floor(rng.random(count) * idx).astype(np.int64)
    src = np.where(kind == 0, idx, src)
    own = _lengths(rng, count, text_group["length"])
    root = src.copy()
    while True:                     # pointer jumping to the fresh root
        nxt = root[root]
        if np.array_equal(nxt, root):
            break
        root = nxt
    return kind, src, own[root]


def _positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Every position of the ranges [starts[i], starts[i] + lens[i])."""
    total = int(lens.sum())
    first = np.cumsum(lens) - lens
    return (np.repeat(starts - first, lens)
            + np.arange(total, dtype=np.int64))


def protein_text(text_group: dict, seed: int,
                 stream: int = PROTEIN_STREAM) -> np.ndarray:
    """The uint8 text of the configuration's ``text`` group for ``seed``
    (``stream``: another text of the same seed, such as a warm-up's)."""
    rng = np.random.default_rng([int(seed), int(stream)])
    n = int(text_group["text_bytes"])
    mean = math.exp(math.log(float(text_group["length"]["median"]))
                    + float(text_group["length"]["sigma"]) ** 2 / 2)
    count = int(n / (mean + 1) * 1.2) + 16
    while True:
        kind, src, lens = _plan(rng, count, text_group)
        ends = np.cumsum(lens + 1)
        if ends[-1] >= n:
            break
        count *= 2
    keep = int(np.searchsorted(ends, n)) + 1     # the last one is cut
    kind, src, lens = kind[:keep], src[:keep], lens[:keep]
    starts = ends[:keep] - lens - 1
    total = int(ends[keep - 1])

    table = residue_table(composition_of(text_group))
    buf = table[rng.integers(0, 1 << TABLE_BITS, total, dtype=np.uint32)]
    lo, hi = text_group["homolog"]["substitution"]
    rate = np.where(kind == 1, rng.uniform(float(lo), float(hi), keep), 0.0)
    # copies in order of depth: a sequence's source is final before it
    depth = np.zeros(keep, np.int64)
    while True:
        nxt = np.where(kind == 0, 0, depth[src] + 1)
        if np.array_equal(nxt, depth):
            break
        depth = nxt
    for d in range(1, int(depth.max()) + 1):
        seqs = np.flatnonzero(depth == d)
        # chunks of sequences, about COPY_CHUNK positions each
        cut = np.searchsorted(np.cumsum(lens[seqs]),
                              np.arange(COPY_CHUNK, int(lens[seqs].sum()),
                                        COPY_CHUNK))
        for part in np.split(seqs, cut):
            if not len(part):
                continue
            dst = _positions(starts[part], lens[part])
            srcpos = _positions(starts[src[part]], lens[part])
            # a substituted residue keeps the fresh draw at its position
            kept = (rng.random(len(dst), dtype=np.float32)
                    >= np.repeat(rate[part], lens[part]).astype(np.float32))
            buf[dst[kept]] = buf[srcpos[kept]]
    buf[starts + lens] = ord("\n")
    text = buf[:n]
    if not is_primitive(text):
        raise AssertionError("the protein text of seed %d is a power of a "
                             "shorter string" % seed)
    return text


def _prime_factors(n: int):
    out, p = [], 2
    while p * p <= n:
        if n % p == 0:
            out.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def is_primitive(text: np.ndarray) -> bool:
    """Whether ``text`` is no power u^k (k > 1) of a shorter string: no
    rotation by n / p, p a prime factor of n, gives the text back."""
    n = len(text)
    for p in _prime_factors(n):
        d = n // p
        head = min(n - d, 4096)
        if (np.array_equal(text[:head], text[d:d + head])
                and np.array_equal(text[:n - d], text[d:])
                and np.array_equal(text[n - d:], text[:d])):
            return False
    return True


def write_text(path: str, text_group: dict, seed: int,
               stream: int = PROTEIN_STREAM) -> None:
    """Write the text for ``seed`` to ``path``."""
    protein_text(text_group, seed, stream).tofile(path)
