"""The least time the card could take for a kernel's work, and the work
of the program's hand-written walks, counted from their shapes.

Peaks are NVIDIA's published figures for one H100 SXM at its full power
limit of 700 W: 3.35 TB/s of device memory and 67 TFLOP/s in float32
outside the tensor cores, which stands for the integer operations of the
walks (the card's int32 rate is lower, so the least time is, if
anything, short, and the share low).  A step's operations are counted
from ``csrc/focc_rows.cuh`` and the kernels' loops, loads excluded: the
row's count and select and the walk's own bookkeeping.  Bytes are each
input read once and each output written once: the rank rows whole, one
text byte and one gt bit a chain step, a lane's seed, start, length and
result, and the samples a harvest writes.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
LF_STEP_OPS = {"sector": 45, "bitplane": 165, "bytes": 150}
CHAIN_STEP_OPS = {"sector": 50, "bitplane": 150, "bytes": 160}
# what a step of a 64-bit form adds
WIDE_STEP_OPS = 24


def bound(nbytes: float, nops: float) -> Tuple[float, str]:
    """(least seconds, the side that binds: "bytes" or "operations"): the
    larger of moving ``nbytes`` once and doing ``nops`` at the peaks."""
    by, op = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    return max(by, op), "bytes" if by >= op else "operations"


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _layout(rows) -> str:
    return getattr(rows, "LAYOUT", "bytes")


def _step_ops(rows, table) -> int:
    wide = type(rows).__name__ == "WideOcc"
    return (table.get(_layout(rows), max(table.values()))
            + (WIDE_STEP_OPS if wide else 0))


def _rows_bytes(rows, steps: float) -> float:
    """The rank rows' bytes a walk of ``steps`` steps has to read: all of
    them, or one row (a 64-byte block a level on wavelet rows) a step
    where that is fewer."""
    rows = getattr(rows, "focc", rows)      # wide rows wrap narrow ones
    parts = [getattr(rows, k, None) for k in ("rows", "blocks", "Zc",
                                              "start", "D")]
    total = _nbytes(*[p for p in parts if hasattr(p, "numel")])
    fused = getattr(rows, "rows", None)
    per_step = (fused.shape[1] * fused.element_size() if fused is not None
                else 64 * getattr(rows, "levels", 1))
    return min(float(total), steps * per_step)


def _total(t) -> float:
    return float(t.sum().item()) if t is not None and len(t) else 0.0


def chain_work(focc, text, gt, c_first, table, kid, starts, seeds, lens,
               gap=None, samp=None, rate=1) -> Tuple[float, float]:
    """(bytes, operations) of one launch of the gap-chain kernel: every
    lane walks ``lens[j]`` steps."""
    steps = _total(lens)
    nbytes = (_rows_bytes(focc, steps) + steps + steps / 8
              + _nbytes(c_first, table, kid, starts, seeds, lens, seeds)
              + (min(_nbytes(gap), 4 * steps) if gap is not None else 0)
              + (steps / max(1, rate) * samp.element_size()
                 if samp is not None else 0))
    return nbytes, steps * _step_ops(focc, CHAIN_STEP_OPS)


def lf_work(focc, r32, l32, p32=None, text=None, bad=None, sarate=1,
            isarate=1, sa=None, isa=None, steps=None, rate=1, dec=None,
            base=0, out_len=0) -> Tuple[float, float]:
    """(bytes, operations) of one launch of the LF-walk kernel in its
    final-rank, verify or harvest visit: lane i takes ``l32[i]`` steps.
    The locate and decode visits walk data-dependent lengths: they are
    not counted (0, 0) and left out of the share."""
    if steps is not None or dec is not None:
        return 0.0, 0.0
    nsteps = _total(l32)
    nbytes = (_rows_bytes(focc, nsteps) + _nbytes(r32, l32, p32, r32)
              + (nsteps if text is not None else 0)
              + _nbytes(sa, isa, bad))
    return nbytes, nsteps * _step_ops(focc, LF_STEP_OPS)
