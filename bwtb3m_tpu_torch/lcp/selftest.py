"""``lcpbit -test``: the self-test harness with brute-force oracles.

Port of ``bwtb3m_tpu/lcp/selftest.py``, which mirrors the reference
tool's harness: the fixed string "abbab#", every string of a small
length over a small alphabet (testnk), random strings over 8 symbols at
growing lengths (testrandomn), a real file (this module's own source)
and the real-genome fixtures under ``testdata/`` when they exist.  The
ground truth is a rotation sort and the Phi/Kasai oracle; every entry of
the PLCP, its succinct bits and its ``.lcpbit`` file is checked.
"""

from __future__ import annotations

import itertools
import os
import tempfile

import numpy as np

from .plcp import (PLCPBitDecoder, compute_plcp, decode_plcp_bits,
                   encode_plcp_bits, kasai_plcp, write_plcp_file)


def _naive_sa(text: np.ndarray) -> np.ndarray:
    """Rotations sorted by value, ties by position.  A byte text compares
    its rotations as ``bytes`` (n^2 bytes of keys, where tuples of
    Python ints take n^2 pointers)."""
    t = np.asarray(text)
    n = len(t)
    doubled = np.concatenate([t, t])
    if n and 0 <= int(t.min()) and int(t.max()) < 256:
        d = doubled.astype(np.uint8).tobytes()

        def key(i):
            return d[i:i + n], i
    else:
        lst = doubled.tolist()

        def key(i):
            return tuple(lst[i:i + n]), i
    return np.array(sorted(range(n), key=key), dtype=np.int64)


def _check_one(text: np.ndarray, device) -> None:
    text = np.asarray(text, dtype=np.int32)
    sigma = int(text.max()) + 1 if len(text) else 1
    plcp, _sa = compute_plcp(text, sigma, device=device)
    ref = kasai_plcp(text, _naive_sa(text))
    if not np.array_equal(plcp, ref):
        raise AssertionError("PLCP mismatch for text %r:\n got %r\n ref %r"
                             % (text.tolist(), plcp.tolist(), ref.tolist()))
    if not np.array_equal(decode_plcp_bits(encode_plcp_bits(plcp),
                                           len(plcp)), plcp):
        raise AssertionError("succinct round trip failed")
    with tempfile.NamedTemporaryFile(suffix=".lcpbit", delete=False) as f:
        path = f.name
    try:
        write_plcp_file(path, plcp)
        if not np.array_equal(PLCPBitDecoder(path, n=len(plcp)).all(), plcp):
            raise AssertionError(".lcpbit round trip failed")
    finally:
        os.unlink(path)


def testn(text, device="cuda"):
    _check_one(np.asarray(text, dtype=np.int32), device)


def testnk(length: int, sigma: int, device="cuda"):
    """Every string of ``length`` symbols over ``sigma``."""
    for tup in itertools.product(range(sigma), repeat=length):
        _check_one(np.array(tup, dtype=np.int32), device)


def testrandomn(n: int, sigma: int = 8, seed: int = 0, device="cuda"):
    rng = np.random.default_rng(seed)
    _check_one(rng.integers(0, sigma, n, dtype=np.int32), device)


def testnxz(path: str, limit: int = 1 << 16, device="cuda"):
    """A real-genome fixture: the first ``limit`` bytes of an ``.xz``
    file; False (skipped) when the file is absent."""
    import lzma

    if not os.path.exists(path):
        return False
    with lzma.open(path, "rb") as f:
        data = np.frombuffer(f.read(limit), dtype=np.uint8).astype(np.int32)
    if len(data):
        _check_one(data[:limit], device)
    return True


def run_selftests(verbose: bool = False, device="cuda") -> int:
    testn([ord(c) for c in "abbab#"], device)
    testnk(6, 2, device)
    testnk(4, 3, device)
    for n in (1024, 4096, 16384):
        testrandomn(n, 8, seed=n, device=device)
    with open(__file__, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    _check_one(data[:4096], device)
    for fix in ("testdata/hg19_000000.xz", "testdata/dmel_test.xz",
                "testdata/ecoli_test.xz"):
        if testnxz(fix, device=device) and verbose:
            print("fixture %s ok" % fix)
    if verbose:
        print("lcpbit selftests ok")
    return 0
