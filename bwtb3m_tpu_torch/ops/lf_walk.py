"""Batched LF walks: the CUDA kernel, its wrapper and plain versions.

One kernel, ``bwt_lf_walk`` in ``csrc/lf_walk.cu``, ports
``bwtb3m_tpu/ops/lf_pallas.py::lf_walk_pallas``.  Four entry points run
it, each with what a step visits:

    lf_walk       the final rank only, as lf_walk_pallas
    verify_walk   checkbwt's walk, <- bwtb3m_tpu/engine/verify.py::_verify_chunk
    harvest_walk  bwtcomputessa's walk, <- bwtb3m_tpu/engine/ssa.py::
                  _harvest_chunk (+ its host loop _harvest_fused)
    select_walk   select_ssa's walk, <- bwtb3m_tpu/engine/ssa.py::
                  _select_chunk: to the first rank whose bit is set

Each thread owns one walk lane and runs all of its steps; a step loads
one rank row and depends on the previous step's rank, so each lane is
bound by load latency.  One lane per preisa seed (~10^5 at the default
rate) hides it, and the walk is then bound by the 32-byte sectors its
steps gather: one on sector rows (sigma <= 4), four on bit-plane rows
(``csrc/lf_walk.cu`` has the measured rates; PERF.md).

An entry point launches the kernel for CUDA tensors and uses its plain
PyTorch version only for CPU tensors; any other device raises.  The one
wrapper, ``_launch``, counts every launch in ``lf_walk.launches`` (and per
visit in ``LAUNCHES``).  Ranks
and positions are int64 tensors at the interface and int32 (uint32
inside the kernel) at the launch: n < 2^31 on every path that calls
these.
"""

from __future__ import annotations

import ctypes

import torch

from .focc import kernel_row_width, lf_step

# ------------------------------------------------------------ plain versions

def lf_walk_plain(focc, r0: torch.Tensor, steps: int) -> torch.Tensor:
    """Final rank of every lane after ``steps`` LF steps."""
    r = r0.long()
    for _ in range(steps):
        _sym, r = lf_step(focc, r)
    return r


def verify_walk_plain(focc, text: torch.Tensor, r0: torch.Tensor,
                      p0: torch.Tensor, seg_len: torch.Tensor) -> torch.Tensor:
    """Per-lane count of steps k < seg_len whose emitted symbol bwt[r]
    differs from text[(p0 - 1 - k) mod n]."""
    n = text.shape[0]
    r, p, lens = r0.long(), p0.long(), seg_len.long()
    bad = torch.zeros_like(r)
    steps = int(lens.max()) if len(lens) else 0
    for k in range(steps):
        sym, r2 = lf_step(focc, r)
        p = torch.where(p == 0, n - 1, p - 1)
        bad += (k < lens) & (sym != text[p].long())
        r = r2
    return bad


def harvest_walk_plain(focc, r0: torch.Tensor, p0: torch.Tensor,
                       seg_len: torch.Tensor, sarate: int, isarate: int):
    """(SA samples, ISA samples): before step k of a lane, with
    p = (p0 - k) mod n, SA[r / sarate] = p when r % sarate == 0 and
    ISA[p / isarate] = r when p % isarate == 0.  Unvisited entries are -1."""
    n = focc.n
    r, p, lens = r0.long(), p0.long(), seg_len.long()
    sa = torch.full(((n + sarate - 1) // sarate,), -1, dtype=torch.int64,
                    device=r.device)
    isa = torch.full(((n + isarate - 1) // isarate,), -1,
                     dtype=torch.int64, device=r.device)
    steps = int(lens.max()) if len(lens) else 0
    for k in range(steps):
        act = k < lens
        hit = act & (r % sarate == 0)
        sa[r[hit] // sarate] = p[hit]
        hit = act & (p % isarate == 0)
        isa[p[hit] // isarate] = r[hit]
        _sym, r = lf_step(focc, r)
        p = torch.where(p == 0, n - 1, p - 1)
    return sa, isa


def select_walk_plain(focc, bitwords: torch.Tensor, r0: torch.Tensor,
                      cap: int):
    """(hit rank, steps) per lane: the lane LF-steps from r0 until bit r
    of ``bitwords`` (uint32 words held as int32) is set, tested before
    each of at most ``cap`` steps; steps is -1 for a lane without a hit
    (its rank is then where the walk stopped)."""
    r = r0.long()
    steps = torch.full_like(r, -1)
    for k in range(cap):
        live = steps < 0
        if not bool(live.any()):
            break
        bit = (bitwords[r >> 5].long() >> (r & 31)) & 1
        steps = torch.where(live & (bit == 1), k, steps)
        _sym, r2 = lf_step(focc, r)
        r = torch.where(steps < 0, r2, r)
    return r, steps


# ------------------------------------------------------------ CUDA wrappers

def _lib():
    from ._build import load
    return load("lf_walk")


def _check(rc: int) -> None:
    if rc != 0:
        msg = _lib().bwt_error_string(rc).decode()
        raise RuntimeError("CUDA kernel launch failed: %s (%d)" % (msg, rc))


def _rows_args(focc, device):
    rows, C = focc.rows, focc.C
    if rows.device != device or C.device != device:
        raise ValueError("rank rows on %s, lanes on %s"
                         % (rows.device, device))
    if C.dtype != torch.int32 or not C.is_contiguous():
        raise TypeError("C must be a contiguous int32 tensor")
    return _ptr(rows), kernel_row_width(focc), _ptr(C), focc.sigma


def _lanes_i32(*ts: torch.Tensor):
    out = []
    for t in ts:
        if t.dim() != 1 or len(t) != len(ts[0]):
            raise ValueError("lane arrays are 1-D and of one length")
        out.append(t.to(torch.int32).contiguous())
    return out


def _check_range(name: str, t: torch.Tensor, hi: int) -> None:
    """Ranks and positions come from .preisa files: a value outside
    [0, hi) would make the kernel read outside its arrays."""
    if len(t) and (int(t.min()) < 0 or int(t.max()) >= hi):
        raise ValueError("%s outside [0, %d)" % (name, hi))


def _ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("no LF-walk kernel for device %s" % t.device)


def _launch(focc, r32: torch.Tensor, l32: torch.Tensor, p32=None, text=None,
            bad=None, sarate=1, isarate=1, sa=None, isa=None, bitwords=None,
            steps=None) -> torch.Tensor:
    """The wrapper of the LF-walk kernel ``bwt_lf_walk``: lane i takes
    ``l32[i]`` LF steps from rank ``r32[i]``; returns the final ranks
    (int32).  With ``text`` it also counts each lane's mismatches into
    ``bad`` (verify visit); with ``sa`` / ``isa`` it writes the samples
    (harvest visit); with ``bitwords`` a lane stops at the first rank
    whose bit is set and ``steps`` takes its step count (select visit).
    Counts its launches in ``lf_walk.launches``."""
    rows, roww, C, sigma = _rows_args(focc, r32.device)
    r_out = torch.empty_like(r32)
    if len(r32) == 0:
        return r_out
    rc = _lib().bwt_lf_walk(rows, roww, C, sigma, focc.n, _ptr(r32),
                            _ptr(p32), _ptr(l32), _ptr(r_out), _ptr(text),
                            _ptr(bad), int(sarate), int(isarate), _ptr(sa),
                            _ptr(isa), _ptr(bitwords), _ptr(steps), len(r32),
                            _stream(r32.device))
    lf_walk.launches += 1
    LAUNCHES["verify" if text is not None else "harvest" if sa is not None
             else "select" if bitwords is not None else "none"] += 1
    _check(rc)
    return r_out


def lf_walk(focc, r0: torch.Tensor, steps: int) -> torch.Tensor:
    """Final rank (int64) of every lane after ``steps`` LF steps."""
    if not _on_cuda(r0):
        return lf_walk_plain(focc, r0, steps)
    _check_range("ranks", r0, focc.n)
    (r32,) = _lanes_i32(r0)
    return _launch(focc, r32, torch.full_like(r32, int(steps))).long()


lf_walk.launches = 0
# the same launches by what a step visits
LAUNCHES = {"none": 0, "verify": 0, "harvest": 0, "select": 0}


def verify_walk(focc, text: torch.Tensor, r0: torch.Tensor, p0: torch.Tensor,
                seg_len: torch.Tensor) -> torch.Tensor:
    """Per-lane mismatch counts (int64) of the checkbwt walk; ``text`` is
    the densified text as a flat uint8 tensor on the lanes' device."""
    if not _on_cuda(r0):
        return verify_walk_plain(focc, text, r0, p0, seg_len)
    if text.dtype != torch.uint8 or text.device != r0.device \
            or not text.is_contiguous() or text.shape[0] != focc.n:
        raise TypeError("text must be a contiguous uint8 tensor of n=%d "
                        "symbols on %s" % (focc.n, r0.device))
    _check_range("ranks", r0, focc.n)
    _check_range("positions", p0, focc.n)
    r32, p32, l32 = _lanes_i32(r0, p0, seg_len)
    bad = torch.zeros_like(r32)
    _launch(focc, r32, l32, p32, text=text, bad=bad)
    return bad.long()


def harvest_walk(focc, r0: torch.Tensor, p0: torch.Tensor,
                 seg_len: torch.Tensor, sarate: int, isarate: int):
    """(SA samples, ISA samples) as int64 tensors, -1 where unvisited."""
    if not _on_cuda(r0):
        return harvest_walk_plain(focc, r0, p0, seg_len, sarate, isarate)
    n = focc.n
    _check_range("ranks", r0, n)
    _check_range("positions", p0, n)
    r32, p32, l32 = _lanes_i32(r0, p0, seg_len)
    sa = torch.full(((n + sarate - 1) // sarate,), -1, dtype=torch.int32,
                    device=r0.device)
    isa = torch.full(((n + isarate - 1) // isarate,), -1, dtype=torch.int32,
                     device=r0.device)
    _launch(focc, r32, l32, p32, sarate=sarate, isarate=isarate, sa=sa,
            isa=isa)
    return sa.long(), isa.long()


def select_walk(focc, bitwords: torch.Tensor, r0: torch.Tensor, cap: int):
    """(hit rank, steps) as int64 tensors, steps -1 where no rank with a
    set bit came within ``cap`` steps; ``bitwords`` holds one bit per
    rank as uint32 words in an int32 tensor of at least n / 32 + 1
    words."""
    if not _on_cuda(r0):
        return select_walk_plain(focc, bitwords, r0, cap)
    if bitwords.dtype != torch.int32 or bitwords.device != r0.device \
            or not bitwords.is_contiguous() \
            or bitwords.shape[0] * 32 <= focc.n:
        raise TypeError("bitwords must be a contiguous int32 tensor of "
                        "more than n=%d bits on %s" % (focc.n, r0.device))
    _check_range("ranks", r0, focc.n)
    (r32,) = _lanes_i32(r0)
    steps = torch.empty_like(r32)
    r_hit = _launch(focc, r32, torch.full_like(r32, int(cap)),
                    bitwords=bitwords, steps=steps)
    return r_hit.long(), steps.long()


def reset_launch_counts() -> None:
    lf_walk.launches = 0
    for k in LAUNCHES:
        LAUNCHES[k] = 0
