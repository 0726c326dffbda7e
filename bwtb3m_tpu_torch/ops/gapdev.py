"""Host side of the anchored gap computation: the wrap-term bits.

For a merge of the left block [s, m) into the right region M = [m, e),
R(p) is the number of rotations of M smaller than rotation p.  Walking
p = m-1 down to s, it follows the recurrence (reference: SURVEY.md
section 3.1 phase 3, arXiv:1604.06687)

    R(p) = c_first[c] + rank_M(c, R(p+1)) - [isa_m < R(p+1) and c == text[m-1]]
           + [c == text[e-1] and rot(p+1) > rot(e)],       c = text[p]

and the gap histogram counts, for every right rank r, the left suffixes
with R(p) = r.  The walks, their anchoring and the histogram are
``ops/gapbatch.py`` (one runner for a single pair merge and for a whole
level).  This module keeps what the host contributes, carried over from
``bwtb3m_tpu/ops/gapdev.py``: the wrap-term bits rot(p+1) > rot(e), from
the native three-way rotation comparator (``native.cmp_rot``), for the
positions whose symbol is text[e-1].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native

TEXT_BLOCK = 256


# ------------------------------------------------------------ host helpers

def cmp_rot(text: np.ndarray, e: int, xs: np.ndarray,
            nthreads: int = 4) -> np.ndarray:
    """sign(rot(x) - rot(e)) for each x in ``xs`` (int8), by the native
    comparator; a chunked numpy compare where the native library is not
    available (CPU runs only: a CUDA run requires the library,
    ``util/devices.py``), as the reference falls back to numpy."""
    n = len(text)
    xs = np.asarray(xs, np.int64)
    out = native.cmp_rot(text, n, e % n, xs, nthreads)
    if out is not None:
        return out[:len(xs)]
    out = np.zeros(len(xs), np.int8)
    ext = np.concatenate([text, text[:min(n, 256)]])
    for b in range(0, len(xs), 1 << 14):
        lanes = np.arange(b, min(len(xs), b + (1 << 14)))
        x, y = xs[lanes] % n, np.full(len(lanes), e % n)
        for _ in range(0, n, 256):
            if not len(lanes):
                break
            L = min(256, n)
            cx = ext[x[:, None] + np.arange(L)]
            cy = ext[y[:, None] + np.arange(L)]
            neq = cx != cy
            hit = neq.any(1)
            j = neq.argmax(1)[hit]
            k = np.flatnonzero(hit)
            out[lanes[k]] = np.where(cx[k, j] > cy[k, j], 1, -1)
            keep = ~hit
            lanes, x, y = lanes[keep], (x[keep] + L) % n, (y[keep] + L) % n
    return out


def wrap_bits(text: np.ndarray, lo: int, cap: int, e: int, sym_last: int,
              nthreads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """The wrap-term bits of a merge ending at ``e`` for the walk
    positions [lo, cap): (positions p with text[p] == sym_last, the only
    ones whose step reads the bit; rot(p+1) > rot(e) for each, bool)."""
    ps = lo + np.flatnonzero(np.asarray(text[lo:cap])
                             == sym_last).astype(np.int64)
    gt = (cmp_rot(text, e, ps + 1, nthreads) > 0 if len(ps)
          else np.zeros(0, bool))
    return ps, gt


def runner_inputs_from_jax(jax_runner) -> dict:
    """The inputs a reference ``DeviceGapRunner`` computed for its walks,
    as numpy: ``c_first``, ``consts`` (isa_m, sym_before_m, sym_last),
    the gt bytes (bit p - lo0 for walk position p, LSB first; trailing
    shape padding included) and ``lo0``."""
    gt = jax_runner._gt_packed
    return {
        "c_first": np.asarray(jax_runner.c_first).astype(np.int64),
        "consts": np.asarray(jax_runner.consts).astype(np.int64),
        "gt": (np.zeros(0, np.uint8) if gt is None
               else np.asarray(gt, np.uint8).reshape(-1)),
        "lo0": int(jax_runner.lo0),
    }
