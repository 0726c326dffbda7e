"""Input-preparation tools: FASTA / digits / bytes -> compact streams.

Port of ``bwtb3m_tpu/cli/prep.py``: fagzToCompact, fagzToCompact4,
fagzToCompactUTerm, fagzToCompact4BigBand(+BiDir), digitsToCompact,
decodecompact, bytestreamToLz4.  All eight are host-only file tools, as
there, on the port's copies of the compact, FASTA and lz4 writers
(``io/compact.py``, ``io/fasta.py``, ``io/lz4io.py``), and write the
reference package's bytes for the same arguments: the same defaults,
output names, seeded N replacement and ``.meta`` records.  The
genome pipeline starts here:

    fagzToCompact4 genome.fa.gz     (genome.fa.gz.compact4 and .meta)
    bwtb3m inputtype=compactstream outputfilename=genome.bwt \
        genome.fa.gz.compact4
    bwtcomputessa genome.bwt        (genome.sa, genome.isa)
    fa4suffixarraytocompact genome.sa genome.fa.gz.compact4.meta

(``outputfilename=`` keeps the build's own ``.meta``, by default
``<input>.meta``, off the compact's, in both packages.)
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..io import compact
from ..io.fasta import iter_fasta
from ..io.lz4io import write_lz4_stream
from ..util import serial
from ..util.args import ArgInfo
from ..util.log import VerboseLog

# base mapping table (upstream fagzToCompact.cpp:113-125): ACGT and acgt
# -> 0..3, every other byte -> -1
_MAP_ACGT = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _MAP_ACGT[_ch] = _i
    _MAP_ACGT[_ch + 32] = _i


def _map_seq(seq: bytes) -> np.ndarray:
    """bytes -> codes 0..3, other -> -1."""
    return _MAP_ACGT[np.frombuffer(seq, dtype=np.uint8)].astype(np.int32)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    """2-bit reverse complement (A<->T, C<->G), non-ACGT (-1 or >3) kept."""
    out = codes[::-1].copy()
    acgt = (out >= 0) & (out <= 3)
    out[acgt] = 3 - out[acgt]
    return out


def fagz_to_compact(argv: List[str]) -> int:
    """FASTA(.gz) -> 3-bit compact: {A,C,G,T}->{1,2,3,4}, other->5,
    terminator 0 after each sequence; rc=1 (default) also emits the reverse
    complement of each sequence (upstream fagzToCompact.cpp:107-176)."""
    ai = ArgInfo(argv, "fagzToCompact")
    if not ai.restargs:
        sys.stderr.write("usage: fagzToCompact [rc=1] [outputfilename=..] "
                         "<in.fa[.gz]>...\n")
        return 1
    rc = ai.get_bool("rc", True)
    out = ai.get("outputfilename") or (ai.restargs[0] + ".compact")
    log = VerboseLog(ai.get_int("verbose", 1))
    with compact.CompactArrayWriter(out, 3) as w:
        for path in ai.restargs:
            for name, seq in iter_fasta(path):
                codes = _map_seq(seq)
                w.put(np.where(codes >= 0, codes + 1, 5).astype(np.int64))
                w.put_one(0)
                if rc:
                    rcodes = _revcomp(codes)
                    rsym = np.where((rcodes >= 0) & (rcodes <= 3),
                                    rcodes + 1, 5)
                    w.put(rsym.astype(np.int64))
                    w.put_one(0)
                log.v("packed %s (%d bases)" % (name, len(seq)))
    log.v("wrote %s" % out)
    return 0


def _write_compact4_meta(path: str, seqs) -> None:
    """Binary meta: nseq, then per sequence (len, nintervals,
    (start, end)*), the N-replacement record of fagzToCompact4
    (upstream fagzToCompact4.cpp:136-258)."""
    with open(path, "wb") as f:
        serial.write_u64(f, len(seqs))
        for slen, intervals in seqs:
            serial.write_u64(f, slen)
            serial.write_u64(f, len(intervals))
            for a, b in intervals:
                serial.write_u64(f, a)
                serial.write_u64(f, b)


def read_compact4_meta(path: str):
    """A fagzToCompact4 ``.meta``: list of (seqlen, [(start, end), ...])."""
    out = []
    with open(path, "rb") as f:
        nseq = serial.read_u64(f)
        for _ in range(nseq):
            slen = serial.read_u64(f)
            k = serial.read_u64(f)
            ivs = [(serial.read_u64(f), serial.read_u64(f)) for _ in range(k)]
            out.append((slen, ivs))
    return out


def _n_intervals(codes: np.ndarray):
    """Maximal runs of non-ACGT positions as (start, end) half-open."""
    bad = codes < 0
    if not bad.any():
        return []
    d = np.diff(bad.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if bad[0]:
        starts = np.concatenate([[0], starts])
    if bad[-1]:
        ends = np.concatenate([ends, [len(codes)]])
    return list(zip(starts.tolist(), ends.tolist()))


def fagz_to_compact4(argv: List[str]) -> int:
    """FASTA(.gz) -> 2-bit compact + .meta: ACGT->{0..3}; non-ACGT runs are
    replaced by seeded random bases (``seed=``, 42) with the intervals
    recorded in .meta, which is read back and checked after the write
    (upstream fagzToCompact4.cpp:174-216, 246-259)."""
    ai = ArgInfo(argv, "fagzToCompact4")
    if not ai.restargs:
        sys.stderr.write("usage: fagzToCompact4 [rc=0] [seed=42] "
                         "[outputfilename=..] <in.fa[.gz]>...\n")
        return 1
    rc = ai.get_bool("rc", False)
    out = ai.get("outputfilename") or (ai.restargs[0] + ".compact4")
    log = VerboseLog(ai.get_int("verbose", 1))
    rng = np.random.default_rng(ai.get_int("seed", 42))
    seq_meta = []
    with compact.CompactArrayWriter(out, 2) as w:
        for path in ai.restargs:
            for name, seq in iter_fasta(path):
                codes = _map_seq(seq)
                ivs = _n_intervals(codes)
                bad = codes < 0
                codes[bad] = rng.integers(0, 4, size=int(bad.sum()))
                w.put(codes.astype(np.int64))
                seq_meta.append((len(codes), ivs))
                if rc:
                    w.put(_revcomp(codes).astype(np.int64))
                    seq_meta.append((len(codes), [
                        (len(codes) - b, len(codes) - a)
                        for a, b in reversed(ivs)]))
                log.v("packed %s (%d bases, %d N-intervals)"
                      % (name, len(seq), len(ivs)))
    _write_compact4_meta(out + ".meta", seq_meta)
    back = read_compact4_meta(out + ".meta")
    if back != [(s, [(int(a), int(b)) for a, b in iv])
                for s, iv in seq_meta]:
        raise AssertionError("%s.meta does not read back as written" % out)
    log.v("wrote %s + .meta (%d seqs)" % (out, len(seq_meta)))
    return 0


def fagz_to_compact_uterm(argv: List[str]) -> int:
    """FASTA(.gz) -> 3-bit compact with unique per-sequence terminators:
    bases->{2..5}, non-ACGT->6, then the sequence id written as ``seqbits``
    sub-symbols in {0,1}, most significant first (upstream
    fagzToCompactUTerm.cpp:77-85,154-165; two passes: the first counts
    the sequences)."""
    ai = ArgInfo(argv, "fagzToCompactUTerm")
    if not ai.restargs:
        sys.stderr.write("usage: fagzToCompactUTerm [outputfilename=..] "
                         "<in.fa[.gz]>...\n")
        return 1
    out = ai.get("outputfilename") or (ai.restargs[0] + ".compactuterm")
    log = VerboseLog(ai.get_int("verbose", 1))
    nseq = sum(1 for path in ai.restargs for _ in iter_fasta(path))
    seqbits = max(1, int(np.ceil(np.log2(max(2, nseq)))))
    sid = 0
    with compact.CompactArrayWriter(out, 3) as w:
        for path in ai.restargs:
            for _name, seq in iter_fasta(path):
                codes = _map_seq(seq)
                w.put(np.where(codes >= 0, codes + 2, 6).astype(np.int64))
                w.put(np.array([(sid >> (seqbits - 1 - b)) & 1
                                for b in range(seqbits)], dtype=np.int64))
                sid += 1
    log.v("wrote %s (%d seqs, seqbits=%d)" % (out, nseq, seqbits))
    return 0


def _bigband(argv: List[str], bidir: bool) -> int:
    """2-bit packing of all sequences forward (non-ACGT replaced by seeded
    random bases), then the reverse complement of the whole forward
    stream; ``bidir``: each sequence followed by its own reverse
    complement.  The functional equivalent of
    ``FastAToCompact4BigBand(BiDir)`` (upstream
    fagzToCompact4BigBand.cpp:47), as the reference package defines it."""
    ai = ArgInfo(argv, "fagzToCompact4BigBand")
    if not ai.restargs:
        sys.stderr.write("usage: fagzToCompact4BigBand [outputfilename=..] "
                         "<in.fa[.gz]>...\n")
        return 1
    out = ai.get("outputfilename") or (ai.restargs[0] + ".compact4bb")
    rng = np.random.default_rng(ai.get_int("seed", 42))
    parts = []
    for path in ai.restargs:
        for _name, seq in iter_fasta(path):
            codes = _map_seq(seq)
            bad = codes < 0
            codes[bad] = rng.integers(0, 4, size=int(bad.sum()))
            parts.append(codes)
    fwd = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    if not bidir:
        stream = np.concatenate([fwd, _revcomp(fwd)])
    elif parts:
        stream = np.concatenate([np.concatenate([p, _revcomp(p)])
                                 for p in parts])
    else:
        stream = fwd
    compact.write_compact(out, stream.astype(np.int64), 2)
    return 0


def fagz_to_compact4_bigband(argv: List[str]) -> int:
    return _bigband(argv, bidir=False)


def fagz_to_compact4_bigband_bidir(argv: List[str]) -> int:
    return _bigband(argv, bidir=True)


def digits_to_compact(argv: List[str]) -> int:
    """Decimal-digit text -> 4-bit compact (other bytes dropped); term=1
    shifts the symbols up by one and appends terminator 0 (upstream
    digitsToCompact.cpp:40-87)."""
    ai = ArgInfo(argv, "digitsToCompact")
    if not ai.restargs:
        sys.stderr.write("usage: digitsToCompact [term=0] "
                         "[outputfilename=..] <in.txt>\n")
        return 1
    term = ai.get_bool("term", False)
    out = ai.get("outputfilename") or (ai.restargs[0] + ".compact")
    raw = np.fromfile(ai.restargs[0], dtype=np.uint8)
    raw = raw[(raw >= ord("0")) & (raw <= ord("9"))] - ord("0")
    sym = raw.astype(np.int64) + (1 if term else 0)
    if term:
        sym = np.concatenate([sym, [0]])
    compact.write_compact(out, sym, 4)
    return 0


def decode_compact(argv: List[str]) -> int:
    """Compact stream -> raw symbol bytes on stdout
    (upstream decodecompact.cpp:30)."""
    ai = ArgInfo(argv, "decodecompact")
    if not ai.restargs:
        sys.stderr.write("usage: decodecompact <in.compact>\n")
        return 1
    sym, _bits = compact.read_compact(ai.restargs[0])
    sys.stdout.buffer.write(sym.astype(np.uint8).tobytes())
    return 0


def bytestream_to_lz4(argv: List[str]) -> int:
    """Byte stream (``-``: stdin) -> LZ4 block stream + index, blocks of
    ``blocksize`` bytes (64k; upstream bytestreamToLz4.cpp:33-45)."""
    ai = ArgInfo(argv, "bytestreamToLz4")
    block = ai.get_int("blocksize", 1 << 16)
    if not ai.restargs:
        sys.stderr.write(
            "usage: bytestreamToLz4 [blocksize=64k] [outputfilename=..] "
            "<in | -(stdin)>\n")
        return 1
    if ai.restargs[0] == "-":
        data = sys.stdin.buffer.read()
        out = ai.get("outputfilename") or "/dev/stdout"
    else:
        with open(ai.restargs[0], "rb") as f:
            data = f.read()
        out = ai.get("outputfilename") or (ai.restargs[0] + ".lz4")
    write_lz4_stream(out, data, block_size=block)
    return 0


TOOLS = {"fagzToCompact": fagz_to_compact, "fagzToCompact4": fagz_to_compact4,
         "fagzToCompactUTerm": fagz_to_compact_uterm,
         "fagzToCompact4BigBand": fagz_to_compact4_bigband,
         "fagzToCompact4BigBandBiDir": fagz_to_compact4_bigband_bidir,
         "digitsToCompact": digits_to_compact, "decodecompact": decode_compact,
         "bytestreamToLz4": bytestream_to_lz4}
