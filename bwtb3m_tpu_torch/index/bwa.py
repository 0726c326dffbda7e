"""BWA index export, the ``bwtb3mtobwa`` tool.

Port of ``bwtb3m_tpu/index/bwa.py`` (host numpy).  The reference tool
(upstream src/bwtb3mtobwa.cpp:29, ``MausFmToBwaConversion::rewrite``)
rewrites a bwtb3m FM index built from ``inputtype=pacterm`` into BWA's
``.bwt`` and ``.sa`` files, after which ``bwa bwtupdate`` interleaves the
occ table.  The bytes equal the reference package's
(tests/test_torch_index_cli.py).

BWA 0.7.x on-disk layouts implemented from the public format:

    .bwt: primary u64 | L2[1..4] 4*u64 | bwt packed u32 words
          (base k at word k>>4, bit offset (15-(k&15))*2; the '$' row is
          dropped, so rows after `primary` shift down by one)
    .sa:  primary u64 | L2[1..4] 4*u64 | sa_intv u64 | seq_len u64 |
          sa[1..n_sa-1] u64 (rank-0 entry, the '$' row, is skipped)

The pacterm BWT (io/inputtypes.py) is the circular BWT of T + terminator
with bases {1..4} and terminator 0: the rank space of BWA's suffix array
of T$, so the conversion is a symbol remap and one row dropped.
"""

from __future__ import annotations

import numpy as np

from ..engine.result import BwtResult
from ..io import formats
from ..util import serial


def rewrite(bwt_path: str, out_bwt: str, out_sa: str, verbose: int = 1) -> None:
    """Convert <base>.bwt (+ .sa sidecar) from a pacterm run into BWA files."""
    result = BwtResult.load(bwt_path)
    if result.sigma != 5:
        raise ValueError(
            "BWA export needs a pacterm BWT (sigma=5, terminator 0); got sigma=%d"
            % result.sigma
        )
    bwt = result.load_bwt()
    n = result.n               # == l_pac + 1 (includes terminator row)
    seq_len = n - 1
    term_rows = np.flatnonzero(bwt == 0)
    if len(term_rows) != 1:
        raise ValueError(
            "expected exactly one terminator in the BWT, found %d" % len(term_rows)
        )
    primary = int(term_rows[0])

    bases = np.delete(bwt, primary) - 1  # drop '$' row, remap {1..4}->{0..3}
    assert len(bases) == seq_len and bases.min() >= 0 and bases.max() <= 3

    counts = np.bincount(bases, minlength=4).astype(np.uint64)
    L2 = np.cumsum(counts)  # L2[1..4] cumulative

    # pack 16 bases per u32, base k at bit offset (15-(k&15))*2
    bwt_size = (seq_len + 15) >> 4
    padded = np.zeros(bwt_size * 16, dtype=np.uint32)
    padded[:seq_len] = bases
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    words = (padded.reshape(-1, 16) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32
    )

    with open(out_bwt, "wb") as f:
        serial.write_u64(f, primary)
        serial.write_u64_array(f, L2)
        f.write(words.astype("<u4").tobytes())

    # .sa from the sampled SA sidecar
    if result.sa_path is None:
        raise ValueError(
            "no sampled .sa available (run without bwtonly or run bwtcomputessa)"
        )
    sa_intv, sa_vals = formats.read_sampled_array(result.sa_path)
    n_sa = (seq_len + sa_intv) // sa_intv
    if len(sa_vals) != n_sa:
        raise ValueError(
            "sampled SA has %d values, expected %d for sa_intv=%d"
            % (len(sa_vals), n_sa, sa_intv)
        )
    if sa_vals[0] != seq_len:
        raise AssertionError("rank-0 SA value should be the terminator position")
    with open(out_sa, "wb") as f:
        serial.write_u64(f, primary)
        serial.write_u64_array(f, L2)
        serial.write_u64(f, sa_intv)
        serial.write_u64(f, seq_len)
        serial.write_u64_array(f, sa_vals[1:].astype("<u8"))
    if verbose:
        import sys
        sys.stderr.write(
            "[V] wrote %s (primary=%d, %d words) and %s (intv=%d, %d values)\n"
            % (out_bwt, primary, bwt_size, out_sa, sa_intv, n_sa - 1)
        )


def read_bwa_bwt(path: str):
    """Read back a BWA .bwt file: (primary, L2[4], bases array)."""
    with open(path, "rb") as f:
        primary = serial.read_u64(f)
        L2 = serial.read_u64_array(f, 4).astype(np.int64)
        words = np.frombuffer(f.read(), dtype="<u4")
    seq_len = int(L2[-1])
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    bases = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1)[:seq_len]
    return primary, L2, bases.astype(np.int64)


def read_bwa_sa(path: str):
    """Read back a BWA .sa file: (primary, L2, sa_intv, seq_len, values)."""
    with open(path, "rb") as f:
        primary = serial.read_u64(f)
        L2 = serial.read_u64_array(f, 4).astype(np.int64)
        sa_intv = serial.read_u64(f)
        seq_len = serial.read_u64(f)
        values = np.frombuffer(f.read(), dtype="<u8").astype(np.int64)
    return primary, L2, sa_intv, seq_len, values
