"""Sampled SA/ISA from .bwt + .preisa — the ``bwtcomputessa`` walk.

Port of ``bwtb3m_tpu/engine/ssa.py::compute_ssa`` (fused path): the
``.preisa`` seeds become walk lanes of one launch of the LF-walk kernel
with its harvest visit (``ops/lf_walk.py::harvest_walk``).  Lane i starts at (rank, position) =
(ranks[i], positions[i]) and walks back to the previous seed; before
each step it writes SA[r / sarate] = p when r % sarate == 0 and
ISA[p / isarate] = r when p % isarate == 0.  Every rank and position is
visited exactly once, so the writes are direct.

Not ported yet: the sigma > 256 legacy path, the wide lanes (n >= 2^31),
``select_ssa``, ``compute_sa_device`` and ``compute_isa_from_preisa``
(ROADMAP.md Queue 1 items 8, 6 and 3).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from bwtb3m_tpu.io import formats
from bwtb3m_tpu.util.log import VerboseLog

from ..ops.lf_walk import harvest_walk
from ..util.devices import resolve_device
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


def compute_ssa(
    bwt_path: str,
    sa_sampling_rate: int = 32,
    isa_sampling_rate: int = 32,
    log: Optional[VerboseLog] = None,
    ref_isa: Optional[str] = None,
    ref_sa: Optional[str] = None,
    device="cuda",
) -> Tuple[str, str]:
    """Write ``<base>.sa`` and ``<base>.isa`` from ``<base>.bwt`` +
    ``<base>.preisa``.  ``ref_sa`` / ``ref_isa`` files, when given, must
    equal what was produced."""
    log = log or VerboseLog(1)
    device = resolve_device(device)
    if sa_sampling_rate < 1 or isa_sampling_rate < 1:
        raise ValueError("sampling rates must be >= 1")
    result = BwtResult.load(bwt_path)
    n = result.n
    if result.sigma > 256:
        raise NotImplementedError(
            "bwtcomputessa for sigma > 256 (legacy rank path) is not "
            "ported yet: ROADMAP.md Queue 1 item 8")
    if n >= 1 << 31:
        raise NotImplementedError(
            "bwtcomputessa for n >= 2^31 (wide lanes) is not ported yet: "
            "ROADMAP.md Queue 1 item 6")
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = seed_segments(ranks, positions, n)
    focc, _symmap = result.load_focc(device, dense=True, log=log)
    t0 = time.monotonic()

    def lanes(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    sa_dev, isa_dev = harvest_walk(
        focc, lanes(ranks), lanes(positions), lanes(seg_len),
        int(sa_sampling_rate), int(isa_sampling_rate))
    sa_vals = sa_dev.cpu().numpy()
    isa_vals = isa_dev.cpu().numpy()
    log.v("ssa: %d lanes, walk + harvest %.3fs (%s)"
          % (len(positions), time.monotonic() - t0, device))
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
