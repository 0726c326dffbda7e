"""Sampled SA/ISA from .bwt + .preisa — the ``bwtcomputessa`` walk and
the tools around it.

Port of ``bwtb3m_tpu/engine/ssa.py`` (fused path).  ``compute_ssa``: the
``.preisa`` seeds become walk lanes of one launch of the LF-walk kernel
with its harvest visit (``ops/lf_walk.py::harvest_walk``).  Lane i starts at (rank, position) =
(ranks[i], positions[i]) and walks back to the previous seed; before
each step it writes SA[r / sarate] = p when r % sarate == 0 and
ISA[p / isarate] = r when p % isarate == 0.  Every rank and position is
visited exactly once, so the writes are direct.

``compute_sa_device`` (the full SA, kept on the device) and
``compute_isa_from_preisa`` (the ``hwtPreIsaToIsa`` tool) are the same
harvest walk at ``sarate=1`` and with only the ISA kept.  ``select_ssa``
gives SA values for arbitrary ranks from ``.bwt`` + ``.preisa`` alone:
each wanted rank is a lane of the kernel's select visit
(``ops/lf_walk.py::select_walk``), which LF-steps until its rank is a
``.preisa`` rank.

Ranks and positions are uint32 in the kernel's narrow form up to 2^32
symbols.  From 2^32 (and under ``BWTB3M_FORCE_WIDE``) the walks of
``compute_ssa`` and ``compute_isa_from_preisa`` take the wide rank rows
and the kernel's 64-bit form (the reference's ``_harvest_fused_w``), with
its rules: a power-of-two SA sampling rate of at least 4 (or one of n or
more, an ISA-only walk), and fewer than 2^31 SA samples.
``compute_sa_device`` stays below 2^31 symbols, as in the reference.
``select_ssa`` walks the narrow select kernel below 2^32 symbols; from
2^32, and past 256 symbols, it answers as the reference does, through the
FM index's locate (``index/fm.py::FMIndex.locate_batch``, the LF-walk
kernel's locate visit over the wide or the wavelet rows), which needs a
sampled ``.sa``.

Past 256 symbols (the reference's legacy ``_harvest_walk``) the walks of
``compute_ssa`` and ``compute_isa_from_preisa`` run over the wavelet
rows of ``ops/wavelet_rows.py`` through the kernel's form
``bwt_lf_walk_wm``, for texts below 2^31 symbols (the reference's int32
lanes; ``ValueError`` past them).  ``compute_sa_device`` raises
``ValueError`` there, and so does ``select_ssa`` when no sampled ``.sa``
exists, as in the reference.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..io import formats
from ..ops.lf_walk import harvest_walk, select_walk
from ..ops.wideocc import WideOcc
from ..util.devices import resolve_device
from ..util.log import VerboseLog
from .result import BwtResult


def load_sampled_array(path: str):
    """(rate, values) of a ``.sa`` / ``.isa`` file that ``compute_ssa``
    wrote."""
    return formats.read_sampled_array(path)


def seed_segments(ranks: np.ndarray, positions: np.ndarray, n: int):
    """Seeds sorted by position plus each lane's segment length: lane i
    walks from positions[i] back to positions[i-1] + 1, and lane 0 (the
    seed at position 0) wraps through n-1, n-2, ... to the last seed."""
    order = np.argsort(positions)
    positions = positions[order]
    ranks = ranks[order]
    if len(positions) == 0 or positions[0] != 0:
        raise ValueError("preisa must contain a sample at position 0")
    seg_len = np.empty(len(positions), dtype=np.int64)
    if len(positions) == 1:
        seg_len[0] = n
    else:
        seg_len[0] = (positions[0] - positions[-1]) % n
        seg_len[1:] = positions[1:] - positions[:-1]
    if seg_len.sum() != n:
        raise ValueError("preisa segments cover %d of n=%d positions"
                         % (seg_len.sum(), n))
    return ranks, positions, seg_len


def _wide_sa_rate(sarate: int, n: int) -> int:
    """The SA rate the 64-bit harvest walks with: the reference's rules
    for wide lanes (``_harvest_fused_w``).  An ISA-only walk (a rate of
    n or more) walks with the power of two at or above n, so that only
    rank 0 lands in its one SA entry, as in the narrow walk."""
    if sarate >= n:
        return 1 << max(0, (n - 1).bit_length())
    if sarate < 4 or sarate & (sarate - 1):
        raise ValueError("texts past 2^32 need a power-of-two sa sampling "
                         "rate >= 4")
    if (n + sarate - 1) // sarate >= 1 << 31:
        raise ValueError("sampled SA exceeds 2^31 entries; raise "
                         "sasamplingrate")
    return sarate


def _harvest(result: BwtResult, sarate: int, isarate: int, device, log,
             wide=None):
    """(SA samples, ISA samples, lanes) on ``device`` (int64, -1 where
    unvisited): the harvest walk from every ``.preisa`` seed, on the wide
    rank rows where ``wide`` (default: ``wide_rows(n)``) says so, on the
    wavelet rows past 256 symbols."""
    n = result.n
    if result.sigma > 256 and n >= 1 << 31:
        raise ValueError("the SA tools past 256 symbols take n < 2^31, as "
                         "the reference's int32 lanes: n=%d" % n)
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = seed_segments(ranks, positions, n)
    if result.sigma > 256:              # the wavelet rows (n < 2^31)
        focc, _symmap = result.load_wavelet(device, dense=True, log=log)
    else:
        focc, _symmap = result.load_focc(device, dense=True, log=log,
                                         wide=wide)
    walk_rate = sarate
    if isinstance(focc, WideOcc):
        walk_rate = _wide_sa_rate(sarate, n)

    def lanes(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    sa, isa = harvest_walk(focc, lanes(ranks), lanes(positions),
                           lanes(seg_len), int(walk_rate), int(isarate))
    if walk_rate != sarate:         # an ISA-only walk: SA[0] only
        sa = sa[:(n + sarate - 1) // sarate]
    return sa, isa, len(positions)


def compute_ssa(
    bwt_path: str,
    sa_sampling_rate: int = 32,
    isa_sampling_rate: int = 32,
    log: Optional[VerboseLog] = None,
    ref_isa: Optional[str] = None,
    ref_sa: Optional[str] = None,
    device="cuda",
    result: Optional[BwtResult] = None,
) -> Tuple[str, str]:
    """Write ``<base>.sa`` and ``<base>.isa`` from ``<base>.bwt`` +
    ``<base>.preisa``.  ``ref_sa`` / ``ref_isa`` files, when given, must
    equal what was produced.  ``result``: the build's own result for
    ``bwt_path``, whose device-rows hand-off the walk may take."""
    log = log or VerboseLog(1)
    device = resolve_device(device)
    if sa_sampling_rate < 1 or isa_sampling_rate < 1:
        raise ValueError("sampling rates must be >= 1")
    result = result or BwtResult.load(bwt_path)
    t0 = time.monotonic()
    sa_dev, isa_dev, nlanes = _harvest(result, sa_sampling_rate,
                                       isa_sampling_rate, device, log)
    sa_vals = sa_dev.cpu().numpy()
    isa_vals = isa_dev.cpu().numpy()
    log.v("ssa: %d lanes, rank rows + walk + harvest %.3fs (%s)"
          % (nlanes, time.monotonic() - t0, device))
    if (sa_vals < 0).any() or (isa_vals < 0).any():
        raise AssertionError(
            "LF walk failed to visit every sampled rank/position")

    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    sa_path, isa_path = base + ".sa", base + ".isa"
    formats.write_sampled_array(sa_path, sa_sampling_rate, sa_vals)
    formats.write_sampled_array(isa_path, isa_sampling_rate, isa_vals)
    log.v("wrote %s (%d values), %s (%d values)"
          % (sa_path, len(sa_vals), isa_path, len(isa_vals)))

    for ref_path, produced, kind in ((ref_sa, sa_vals, "sa"),
                                     (ref_isa, isa_vals, "isa")):
        if ref_path:
            _rrate, ref_vals = formats.read_sampled_array(ref_path)
            if len(ref_vals) != len(produced) or (ref_vals != produced).any():
                raise AssertionError("%s mismatch vs reference file %s"
                                     % (kind, ref_path))
            log.v("%s matches reference %s" % (kind, ref_path))
    return sa_path, isa_path


def compute_sa_device(bwt_path: str, log: Optional[VerboseLog] = None,
                      device="cuda"):
    """The full suffix array by LF walk, kept on the device: (sa int64
    tensor of n on ``device``, n).  The harvest walk at ``sarate=1``;
    the device-resident PLCP path derives ISA and Phi from it."""
    log = log or VerboseLog(0)
    device = resolve_device(device)
    result = BwtResult.load(bwt_path)
    n = result.n
    if n >= 1 << 31 or result.sigma > 256:
        raise ValueError("compute_sa_device needs n < 2^31, sigma <= 256")
    sa, _isa, _nlanes = _harvest(result, 1, n, device, log, wide=False)
    if bool((sa < 0).any()):
        raise AssertionError("LF walk failed to visit every rank")
    return sa, n


def compute_isa_from_preisa(bwt_path: str, isa_sampling_rate: int = 64,
                            log: Optional[VerboseLog] = None,
                            device="cuda") -> str:
    """The ``hwtPreIsaToIsa`` tool: ``.bwt`` + ``.preisa`` -> ``.isa`` at
    the requested rate.  The harvest walk with ``sarate=n``, so only
    rank 0 lands in its SA output, which is dropped."""
    log = log or VerboseLog(1)
    device = resolve_device(device)
    if isa_sampling_rate < 1:
        raise ValueError("sampling rates must be >= 1")
    result = BwtResult.load(bwt_path)
    _sa, isa, _nlanes = _harvest(result, result.n, isa_sampling_rate,
                                 device, log)
    isa_vals = isa.cpu().numpy()
    if (isa_vals < 0).any():
        raise AssertionError("LF walk failed to reach every sampled "
                             "position")
    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    isa_path = base + ".isa"
    formats.write_sampled_array(isa_path, isa_sampling_rate, isa_vals)
    log.v("wrote %s (%d values)" % (isa_path, len(isa_vals)))
    return isa_path


def select_ssa(bwt_path: str, ranks: np.ndarray,
               log: Optional[VerboseLog] = None, device="cuda"
               ) -> np.ndarray:
    """SA values (int64) for an arbitrary set of ranks, from ``.bwt`` +
    ``.preisa`` alone (no sampled ``.sa`` needed, so it serves a
    ``bwtonly=1`` build).  The wanted ranks are walk lanes; a bitmap on
    the device marks the ``.preisa`` ranks, and every lane LF-steps until
    its rank's bit is set: the samples are equidistant in position, so a
    backward walk meets one within one sampling interval.  Then
    SA[wanted] = position of the hit rank + steps, resolved on the host
    against the ``.preisa`` pairs.  A lane that walks 2 * (rate + 512)
    steps without a hit is an error.  From 2^32 symbols and past 256
    symbols: ``FMIndex.locate_batch`` over the sampled ``.sa``, as in the
    reference."""
    log = log or VerboseLog(0)
    device = resolve_device(device)
    result = BwtResult.load(bwt_path)
    n = result.n
    ranks = np.asarray(ranks, dtype=np.int64)
    if (ranks < 0).any() or (ranks >= n).any():
        raise ValueError("ranks out of range")
    if result.sigma > 256 or n >= 1 << 32:
        from ..index.fm import FMIndex
        if result.sa_path is None:
            raise ValueError("select_ssa past 2^32 (or sigma > 256) "
                             "currently needs a sampled .sa")
        fm = FMIndex.from_bwt_result(result, structure="hwt", device=device)
        return fm.locate_batch(ranks)
    pr_ranks, pr_pos, prate = result.load_preisa()
    focc, _symmap = result.load_focc(device, dense=True, log=log, wide=False)
    words = np.zeros(n // 32 + 1, np.uint32)
    np.bitwise_or.at(words, pr_ranks >> 5,
                     np.uint32(1) << (pr_ranks & 31).astype(np.uint32))
    bitwords = torch.from_numpy(words.view(np.int32)).to(device)
    t0 = time.monotonic()
    cap = 2 * (int(prate) + 512)
    r_hit, steps = select_walk(focc, bitwords,
                               torch.from_numpy(ranks).to(device), cap)
    r_hit, steps = r_hit.cpu().numpy(), steps.cpu().numpy()
    log.v("select: %d lanes, walk %.3fs (%s), %d steps at most"
          % (len(ranks), time.monotonic() - t0, device,
             int(steps.max(initial=0))))
    if (steps < 0).any():
        raise AssertionError(
            "select walk exceeded the preisa sampling interval")
    order = np.argsort(pr_ranks)
    slot = np.searchsorted(pr_ranks[order], r_hit)
    assert (pr_ranks[order][slot] == r_hit).all()
    return (pr_pos[order][slot] + steps) % n
