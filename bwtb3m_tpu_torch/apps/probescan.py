"""probeScanDna: k-mer abundance of query probes against a reference.

Port of ``bwtb3m_tpu/apps/probescan.py``.  The reference tool (upstream
src/probeScanDna.cpp) has three modes: ``words`` (3-bit packed k-mer sort
and lookup scan, :141-423), ``hwt`` and ``rlhwt`` (backward search
``LF.step(sym, lo, hi)`` per symbol, :100-107); it reports abundance
histogram columns (``evaluateAcc``, :32-53).  The JAX package adds
``occ``, a device-batched backward search.

Here ``occ``, ``hwt`` and ``rlhwt`` are one batched backward search on
the card over every k-mer of every probe: k calls of
``ops/lf.py::backward_search_step``, each stepping all k-mers by one
symbol over the build's rank rows.  ``occ`` takes the k-mer codes (+1 on
a pacterm build) as the rows' dense ids, as the reference's ``occ`` mode
does; ``hwt`` and ``rlhwt`` take them as the file's symbols through the
FM index's symbol map, as the reference's ``fm.count`` does.  The counts
equal the reference's in every mode.  ``words`` stays host code.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from ..engine.result import BwtResult
from ..index.fm import FMIndex
from ..io import compact
from ..io.fasta import iter_fasta
from ..ops.lf import backward_search_step, c_values
from ..util.devices import resolve_device
from ..util.log import VerboseLog

_MAP = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _MAP[ch] = i
    _MAP[ch + 32] = i

KMER_CHUNK = 1 << 20        # k-mers stepped together


def _probe_kmers(seq: bytes, k: int) -> np.ndarray:
    """[kmers, k] codes of the probe's k-mers without a non-ACGT base, in
    order."""
    codes = _MAP[np.frombuffer(seq, dtype=np.uint8)].astype(np.int64)
    if len(codes) < k:
        return np.zeros((0, k), np.int64)
    w = np.lib.stride_tricks.sliding_window_view(codes, k)
    return w[(w >= 0).all(axis=1)]


def _evaluate_acc(counts: np.ndarray, log: VerboseLog) -> None:
    """Histogram columns: fraction of k-mers with abundance 0, 1, 2-10, >10
    (evaluateAcc role)."""
    total = max(1, len(counts))
    cols = [
        ("c0", np.count_nonzero(counts == 0)),
        ("c1", np.count_nonzero(counts == 1)),
        ("c2_10", np.count_nonzero((counts >= 2) & (counts <= 10))),
        ("c_gt10", np.count_nonzero(counts > 10)),
    ]
    log.m("  ".join("%s=%.4f" % (k, v / total) for k, v in cols))


def kmer_counts(rows, dense: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each k-mer ([K, k] dense ids on the rows' device,
    -1 or >= sigma where a symbol is absent) as a rotation prefix: one
    batched backward search, the last column first, in chunks of
    ``KMER_CHUNK`` k-mers."""
    C = c_values(rows)
    sigma = len(C) - 1
    out = torch.zeros(dense.shape[0], dtype=torch.int64, device=dense.device)
    for a in range(0, dense.shape[0], KMER_CHUNK):
        km = dense[a:a + KMER_CHUNK]
        absent = ((km < 0) | (km >= sigma)).any(1)
        lo = torch.zeros(km.shape[0], dtype=torch.int64, device=km.device)
        hi = torch.full_like(lo, n)
        for j in range(km.shape[1] - 1, -1, -1):
            lo, hi = backward_search_step(rows, km[:, j].clamp(0, sigma - 1),
                                          lo, hi, C)
        out[a:a + KMER_CHUNK] = torch.where(absent, 0, (hi - lo).clamp(min=0))
    return out


def _read_probes(probes_path: str, k: int):
    names, kms = [], []
    for name, seq in iter_fasta(probes_path):
        names.append(name)
        kms.append(_probe_kmers(seq, k))
    spans = np.cumsum([0] + [len(x) for x in kms])
    allk = np.concatenate(kms) if kms else np.zeros((0, k), np.int64)
    return names, allk, spans


def _print_lines(names, counts_all, spans) -> None:
    for name, a, b in zip(names, spans[:-1], spans[1:]):
        counts = counts_all[a:b]
        mean = float(counts.mean()) if len(counts) else 0.0
        matched = int(np.count_nonzero(counts)) if len(counts) else 0
        print("%s\t%d\t%d\t%.3f" % (name, len(counts), matched, mean))


def probe_scan(ref_path: str, probes_path: str, mode: str = "hwt",
               k: int = 31, device="cuda") -> int:
    log = VerboseLog(1)
    if mode in ("occ", "hwt", "rlhwt"):
        device = resolve_device(device)
        result = BwtResult.load(ref_path)
        # pacterm texts carry bases as {1..4}; pac/compact4 as {0..3}
        shift = 1 if result.sigma == 5 else 0
        if mode == "occ":
            if result.sigma > 256:
                rows, _symmap = result.load_wavelet(device, dense=True)
            else:
                rows, _symmap = result.load_focc(device, dense=True)
            n = rows.n
        else:
            fm = FMIndex.from_bwt_result(result, structure=mode,
                                         device=device)
            rows, n = fm.rows, fm.n
        names, allk, spans = _read_probes(probes_path, k)
        km = torch.from_numpy(allk + shift).to(device)
        if mode != "occ":
            km = fm.dense_ids(km.reshape(-1)).reshape(km.shape)
        counts_all = kmer_counts(rows, km, n).cpu().numpy()
        _print_lines(names, counts_all, spans)
        if mode == "occ":
            if len(counts_all):
                _evaluate_acc(counts_all, log)
        elif names:
            _evaluate_acc(counts_all, log)
        return 0
    if mode != "words":
        sys.stderr.write("probeScanDna: unknown mode %r\n" % mode)
        return 1
    text, bits = compact.read_compact(ref_path)
    if k > 63:
        raise ValueError("words mode supports k <= 63")
    # k-mers are packed 2 bits per base: only 2-bit compact input
    # (fagzToCompact4 output, bases {0..3}) yields valid keys; a 3-bit
    # stream (fagzToCompact, symbols {0..5}) would corrupt every k-mer
    if bits != 2 or (len(text) and int(text.max()) > 3):
        raise ValueError(
            "words mode needs a 2-bit compact reference "
            "(fagzToCompact4 output with bases 0..3); got bits=%d" % bits)
    n = len(text)
    t = text.astype(np.uint64)
    nw = max(0, n - k + 1)
    if k <= 31:
        # single-word packed k-mers (reference uint64 width)
        packed = np.zeros(nw, dtype=np.uint64)
        for j in range(k):
            packed = (packed << np.uint64(2)) | t[j : nw + j]
        packed.sort(kind="stable")

        def count(km: np.ndarray) -> int:
            v = np.uint64(0)
            for c in km:
                v = (v << np.uint64(2)) | np.uint64(c)
            lo = np.searchsorted(packed, v, side="left")
            hi = np.searchsorted(packed, v, side="right")
            return int(hi - lo)
    else:
        # two-word packed k-mers (reference uint128 width,
        # probeScanDna.cpp:482-486) via a structured (hi, lo) sort
        khi = k - 31
        hi_w = np.zeros(nw, dtype=np.uint64)
        for j in range(khi):
            hi_w = (hi_w << np.uint64(2)) | t[j : nw + j]
        lo_w = np.zeros(nw, dtype=np.uint64)
        for j in range(khi, k):
            lo_w = (lo_w << np.uint64(2)) | t[j : nw + j]
        packed = np.empty(nw, dtype=[("hi", "<u8"), ("lo", "<u8")])
        packed["hi"] = hi_w
        packed["lo"] = lo_w
        packed.sort(order=("hi", "lo"))

        def count(km: np.ndarray) -> int:
            vh = 0
            for c in km[:khi]:
                vh = (vh << 2) | int(c)
            vl = 0
            for c in km[khi:]:
                vl = (vl << 2) | int(c)
            key = np.array((vh, vl), dtype=packed.dtype)
            lo = np.searchsorted(packed, key, side="left")
            hi = np.searchsorted(packed, key, side="right")
            return int(hi - lo)

    names, allk, spans = _read_probes(probes_path, k)
    counts_all = np.array([count(km) for km in allk], dtype=np.int64)
    _print_lines(names, counts_all, spans)
    if names:
        _evaluate_acc(counts_all, log)
    return 0
