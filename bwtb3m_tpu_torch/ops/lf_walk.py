"""Batched LF walks: the CUDA kernel, its wrapper and plain versions.

One kernel, ``bwt_lf_walk`` in ``csrc/lf_walk.cu``, ports
``bwtb3m_tpu/ops/lf_pallas.py::lf_walk_pallas``.  Three entry points run
it, each with what a step visits, and a fourth runs the select kernel of
the same source, ``bwt_lf_select``:

    lf_walk       the final rank only, as lf_walk_pallas
    verify_walk   checkbwt's walk, <- bwtb3m_tpu/engine/verify.py::_verify_chunk
    harvest_walk  bwtcomputessa's walk, <- bwtb3m_tpu/engine/ssa.py::
                  _harvest_chunk (+ its host loop _harvest_fused)
    select_walk   select_ssa's walk, <- bwtb3m_tpu/engine/ssa.py::
                  _select_chunk: to the first rank whose bit is set; a
                  persistent grid whose lanes refill, testing a summary
                  bitmap (``select_summary``) before the exact one
    locate_walk   the FM index's locate, <- bwtb3m_tpu/index/fm.py::
                  FMIndex.locate_batch: to the first rank that is a
                  multiple of the sampled SA's rate (each lane to its
                  end; the kernel's visit kLocate)
    decode_walk   the FM index's extract and bwtdecodeblock, <-
                  bwtb3m_tpu/index/fm.py::FMIndex.extract: the verify
                  walk with its comparison replaced by a store (kDecode)

Each thread owns one walk lane and runs all of its steps; a step loads
one rank row and depends on the previous step's rank, so each lane is
bound by load latency.  One lane per preisa seed (~10^5 at the default
rate) hides it, and the walk is then bound by the 32-byte sectors its
steps gather: one on sector rows (sigma <= 4), four on bit-plane rows
(``csrc/lf_walk.cu`` has the measured rates; PERF.md).

Past 256 symbols the rank rows are the wavelet rows of
``ops/wavelet_rows.py`` and the first three entry points take the
kernel's form ``bwt_lf_walk_wm`` (narrow, n < 2^31; the text uint16 bits
in an int16 tensor; so do the locate and decode walks): the port of the
reference's walks over its ``OccTable``, ``ops/lf.py::lf_walk``,
``engine/verify.py::_walk_verify_run`` and ``engine/ssa.py::
_harvest_walk``.  A step is one
descent, a 64-byte block per level of three bits.

An entry point launches the kernel for CUDA tensors and uses its plain
PyTorch version only for CPU tensors; any other device raises.  Ranks
and positions are int64 tensors at the interface.  On narrow rank rows
(n < 2^32) they travel as int32 tensors of uint32 bits: 0xFFFFFFFF, no
rank or position there, marks an unvisited sample.  On the wide rows of
``ops/wideocc.py`` (n >= 2^32, or ``BWTB3M_FORCE_WIDE``) the entry
points take the kernel's 64-bit form, ``bwt_lf_walk_w``, with int64
lanes (the locate and decode walks too); the select walk stays narrow,
as in the reference.  The four
wrappers, ``_launch``, ``_launch_w``, ``_launch_wm`` and
``_launch_select``, count every launch in ``lf_walk.launches`` and per
visit and form in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import wavelet_rows as wr
from .focc import as_u32_bits, from_u32_bits, kernel_row_width, lf_step
from .wavelet_rows import WaveletRows, symbol_values
from .wideocc import WideOcc, kernel_tables, lf_step_w

# the select kernel: one summary bit per block of 2^SUMMARY_SHIFT ranks,
# and SELECT_BLOCKS_PER_SM blocks of 256 threads per SM in its persistent
# grid (chip_smoke.py's select sweep, PERF.md)
SUMMARY_SHIFT = 8
SELECT_BLOCKS_PER_SM = 4


def _step_of(focc):
    """The plain LF step of narrow, wide or wavelet rank rows."""
    if isinstance(focc, WaveletRows):
        return wr.lf_step
    return lf_step_w if isinstance(focc, WideOcc) else lf_step

# ------------------------------------------------------------ plain versions

def lf_walk_plain(focc, r0: torch.Tensor, steps: int) -> torch.Tensor:
    """Final rank of every lane after ``steps`` LF steps."""
    r, step = r0.long(), _step_of(focc)
    for _ in range(steps):
        _sym, r = step(focc, r)
    return r


def verify_walk_plain(focc, text: torch.Tensor, r0: torch.Tensor,
                      p0: torch.Tensor, seg_len: torch.Tensor) -> torch.Tensor:
    """Per-lane count of steps k < seg_len whose emitted symbol bwt[r]
    differs from text[(p0 - 1 - k) mod n] (int16 text: uint16 bits)."""
    n = text.shape[0]
    r, p, lens = r0.long(), p0.long(), seg_len.long()
    bad = torch.zeros_like(r)
    step = _step_of(focc)
    steps = int(lens.max()) if len(lens) else 0
    for k in range(steps):
        sym, r2 = step(focc, r)
        p = torch.where(p == 0, n - 1, p - 1)
        bad += (k < lens) & (sym != symbol_values(text[p]))
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
    step = _step_of(focc)
    steps = int(lens.max()) if len(lens) else 0
    for k in range(steps):
        act = k < lens
        hit = act & (r % sarate == 0)
        sa[r[hit] // sarate] = p[hit]
        hit = act & (p % isarate == 0)
        isa[p[hit] // isarate] = r[hit]
        _sym, r = step(focc, r)
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


def locate_walk_plain(focc, r0: torch.Tensor, rate: int):
    """(rank, steps) per lane: LF steps from r0 until the rank is a
    multiple of ``rate``, the live lanes stepping together as the
    reference's ``locate_batch`` steps them; a lane still walking after
    n steps (LF of more than one cycle) ends there with steps -1."""
    r = r0.long().clone()
    steps = torch.zeros_like(r)
    live = torch.nonzero(r % rate != 0).squeeze(1)
    step = _step_of(focc)
    k = 0
    while len(live):
        if k == focc.n:
            steps[live] = -1
            break
        _sym, r2 = step(focc, r[live])
        r[live] = r2
        steps[live] += 1
        live = live[r2 % rate != 0]
        k += 1
    return r, steps


def decode_walk_plain(focc, r0: torch.Tensor, p0: torch.Tensor,
                      seg_len: torch.Tensor, base: int, length: int):
    """text[base : base + length] (circular) from lanes that start at
    rank r0 and text position p0 and take seg_len steps: step k emits
    bwt[r] = text[p] with p = (p0 - 1 - k) mod n, stored at offset
    (p - base) mod n where that is below ``length``.  uint8 symbols, or
    int16 (uint16 bits) on wavelet rows; offsets no lane reaches hold 0."""
    n = focc.n
    dt = torch.int16 if isinstance(focc, WaveletRows) else torch.uint8
    out = torch.zeros(length, dtype=dt, device=r0.device)
    r, p, lens = r0.long(), p0.long(), seg_len.long()
    step = _step_of(focc)
    steps = int(lens.max()) if len(lens) else 0
    for k in range(steps):
        sym, r = step(focc, r)
        p = torch.where(p == 0, n - 1, p - 1)
        o = (p - base) % n
        put = (k < lens) & (o < length)
        out[o[put]] = (wr.as_u16_bits(sym[put]) if dt == torch.int16
                       else sym[put].to(dt))
    return out


def select_summary(bitwords: torch.Tensor,
                   shift: int = SUMMARY_SHIFT) -> torch.Tensor:
    """The select kernel's summary of a bitmap (uint32 words held as
    int32): bit b is set where ranks [b << shift, (b + 1) << shift) hold a
    set bit.  Built with torch on the bitmap's device; int32 words of
    uint32 bits, enough for every rank the bitmap covers."""
    if shift < 5:
        raise ValueError("a summary block holds whole bitmap words")
    per = 1 << (shift - 5)
    nblk = -(-bitwords.shape[0] // per)
    w = bitwords
    if nblk * per != w.shape[0]:
        w = torch.cat([w, w.new_zeros(nblk * per - w.shape[0])])
    hit = (w.view(nblk, per) != 0).any(1)
    nw = -(-nblk // 32)
    hit = torch.cat([hit, hit.new_zeros(nw * 32 - nblk)]).view(nw, 32)
    return as_u32_bits((hit.long() << torch.arange(32, device=hit.device))
                       .sum(1))


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
    if focc.n >= 1 << 32:
        raise ValueError("narrow rank rows hold n < 2^32 symbols: n=%d "
                         "takes the wide rows (ops/wideocc.py)" % focc.n)
    return _ptr(rows), kernel_row_width(focc), _ptr(C), focc.sigma


def _lanes(ts, wide: bool):
    """Ranks / positions as the launch takes them: int32 tensors of
    uint32 bits, or int64 for the 64-bit form."""
    out = []
    for t in ts:
        if t.dim() != 1 or len(t) != len(ts[0]):
            raise ValueError("lane arrays are 1-D and of one length")
        out.append(t.long().contiguous() if wide
                   else as_u32_bits(t.long()).contiguous())
    return out


def _steps_i32(t: torch.Tensor) -> torch.Tensor:
    if len(t) and int(t.max()) >= 1 << 31:
        raise ValueError("a lane takes fewer than 2^31 steps")
    return t.to(torch.int32).contiguous()


def _samples(t: torch.Tensor) -> torch.Tensor:
    """Samples written by the narrow form (uint32 bits, 0xFFFFFFFF where
    unvisited) -> int64, -1 where unvisited; in place on one int64 copy
    (a full SA's temporaries set the genome PLCP's peak memory)."""
    v = t.long()
    v &= 0xFFFFFFFF
    return v.masked_fill_(v == 0xFFFFFFFF, -1)


def _check_range(name: str, t: torch.Tensor, hi: int) -> None:
    """Ranks and positions come from .preisa files: a value outside
    [0, hi) would make the kernel read outside its arrays."""
    if len(t) and (int(t.min()) < 0 or int(t.max()) >= hi):
        raise ValueError("%s outside [0, %d)" % (name, hi))


def _u32_arg(v: int) -> int:
    """A uint32 for a C ``int`` parameter that the kernel reads as uint32
    (the narrow form's rates: an ISA-only walk passes sarate = n, which
    may pass 2^31): its int32 bits."""
    v = int(v)
    if not 0 <= v < 1 << 32:
        raise ValueError("a rate of the narrow walk lies in [0, 2^32)")
    return v - (1 << 32) if v >= 1 << 31 else v


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
            bad=None, sarate=1, isarate=1, sa=None, isa=None, steps=None,
            rate=1, dec=None, base=0, out_len=0) -> torch.Tensor:
    """The wrapper of the LF-walk kernel ``bwt_lf_walk``: lane i takes
    ``l32[i]`` LF steps from rank ``r32[i]``; returns the final ranks
    (int32 of uint32 bits).  With ``text`` it also counts each lane's
    mismatches into ``bad`` (verify visit); with ``sa`` / ``isa`` it
    writes the samples (harvest visit); with ``steps`` (int64) each lane
    walks to the first multiple of ``rate`` instead (locate visit, ``l32``
    unread); with ``dec`` it
    stores the symbols of text offsets [0, out_len) from position
    ``base`` (decode visit).  Counts its launches in
    ``lf_walk.launches``."""
    rows, roww, C, sigma = _rows_args(focc, r32.device)
    r_out = torch.empty_like(r32)
    if len(r32) == 0:
        return r_out
    rc = _lib().bwt_lf_walk(rows, roww, C, sigma, focc.n, _ptr(r32),
                            _ptr(p32), _ptr(l32), _ptr(r_out), _ptr(text),
                            _ptr(bad), _u32_arg(sarate), _u32_arg(isarate),
                            _ptr(sa), _ptr(isa), _ptr(steps), int(rate),
                            _ptr(dec), int(base), int(out_len), len(r32),
                            _stream(r32.device))
    lf_walk.launches += 1
    LAUNCHES[_visit(text, sa, steps, dec)] += 1
    _check(rc)
    return r_out


def _visit(text, sa, steps=None, dec=None) -> str:
    return ("locate" if steps is not None else "decode" if dec is not None
            else "verify" if text is not None else "harvest"
            if sa is not None else "none")


def _launch_select(focc, bitwords: torch.Tensor, summary: torch.Tensor,
                   r32: torch.Tensor, cap: int, blocks: int,
                   shift: int = SUMMARY_SHIFT):
    """The wrapper of the select kernel ``bwt_lf_select``: a persistent
    grid of ``blocks`` blocks walks the wanted ranks ``r32`` (int32 of
    uint32 bits), taking the next one as a lane ends; returns (hit ranks
    as int32 of uint32 bits, int32 steps).  Counts its launches in
    ``lf_walk.launches`` and ``LAUNCHES["select"]``."""
    rows, roww, C, sigma = _rows_args(focc, r32.device)
    r_out = torch.empty_like(r32)
    steps = torch.empty(len(r32), dtype=torch.int32, device=r32.device)
    if len(r32) == 0:
        return r_out, steps
    if not 0 <= cap < 1 << 31 or len(r32) + blocks * 256 >= 1 << 31:
        raise ValueError("the select kernel takes cap < 2^31 and fewer "
                         "than 2^31 lanes")
    nxt = torch.zeros(1, dtype=torch.int32, device=r32.device)
    rc = _lib().bwt_lf_select(rows, roww, C, sigma, _ptr(r32), _ptr(r_out),
                              _ptr(steps), _ptr(bitwords), _ptr(summary),
                              int(shift), int(cap), len(r32), _ptr(nxt),
                              int(blocks), _stream(r32.device))
    lf_walk.launches += 1
    LAUNCHES["select"] += 1
    _check(rc)
    return r_out, steps


def select_blocks(device, nlanes: int) -> int:
    """The select kernel's persistent grid: ``SELECT_BLOCKS_PER_SM``
    blocks of 256 threads on each SM of the card, no more than the lanes
    fill."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * SELECT_BLOCKS_PER_SM, -(-nlanes // 256)))


def _launch_w(w: WideOcc, r64: torch.Tensor, l32: torch.Tensor, p64=None,
              text=None, bad=None, sarate=1, isarate=1, sa=None, isa=None,
              steps=None, rate=1, dec=None, base=0,
              out_len=0) -> torch.Tensor:
    """The wrapper of the kernel's 64-bit form ``bwt_lf_walk_w`` on wide
    rank rows: as ``_launch`` with int64 ranks, positions and samples (the
    harvest's ``sarate`` a power of two), no select visit.  Counts its
    launches in ``lf_walk.launches`` and ``LAUNCHES["<visit>64"]``."""
    focc = w.focc
    if focc.rows.device != r64.device:
        raise ValueError("rank rows on %s, lanes on %s"
                         % (focc.rows.device, r64.device))
    if sa is not None and sarate & (sarate - 1):
        raise ValueError("the 64-bit form takes a power-of-two sarate")
    thr, C64 = kernel_tables(w)
    r_out = torch.empty_like(r64)
    if len(r64) == 0:
        return r_out
    rc = _lib().bwt_lf_walk_w(
        _ptr(focc.rows), kernel_row_width(focc), _ptr(C64), _ptr(thr),
        w.sigma, focc.n, _ptr(r64), _ptr(p64), _ptr(l32), _ptr(r_out),
        _ptr(text), _ptr(bad), int(sarate), int(isarate), _ptr(sa),
        _ptr(isa), _ptr(steps), int(rate), _ptr(dec), int(base),
        int(out_len), len(r64), _stream(r64.device))
    lf_walk.launches += 1
    LAUNCHES[_visit(text, sa, steps, dec) + "64"] += 1
    _check(rc)
    return r_out


def _launch_wm(wm: WaveletRows, r32: torch.Tensor, l32: torch.Tensor,
               p32=None, text=None, bad=None, sarate=1, isarate=1, sa=None,
               isa=None, steps=None, rate=1, dec=None, base=0,
               out_len=0) -> torch.Tensor:
    """The wrapper of the kernel's form over wavelet rows,
    ``bwt_lf_walk_wm``: as ``_launch`` (uint32 bits in int32 lanes), the
    verify visit's text and the decode visit's output int16 (uint16
    bits).  Counts its launches in ``lf_walk.launches`` and
    ``LAUNCHES["<visit>_wm"]``."""
    dev = r32.device
    wr.check_kernel_rows(wm, dev, wm.D)
    r_out = torch.empty_like(r32)
    if len(r32) == 0:
        return r_out
    rc = _lib().bwt_lf_walk_wm(
        _ptr(wm.blocks), wm.nblk, wm.levels, _ptr(wm.Zc), _ptr(wm.D),
        wm.sigma, wr.smem_bytes(wm.sigma), wm.n, _ptr(r32), _ptr(p32),
        _ptr(l32), _ptr(r_out), _ptr(text), _ptr(bad), _u32_arg(sarate),
        _u32_arg(isarate), _ptr(sa), _ptr(isa), _ptr(steps), int(rate),
        _ptr(dec), int(base), int(out_len), len(r32), _stream(dev))
    lf_walk.launches += 1
    LAUNCHES[_visit(text, sa, steps, dec) + "_wm"] += 1
    _check(rc)
    return r_out


def _go(focc, r, l32, p=None, **kw):
    """Launch the kernel's form for the rows (narrow, 64-bit on wide
    rows, or over wavelet rows) on ranks ``r`` and positions ``p``; the
    final ranks, int64."""
    wide = isinstance(focc, WideOcc)
    lanes = _lanes([r] + ([p] if p is not None else []), wide)
    if wide:
        return _launch_w(focc, lanes[0], l32, *lanes[1:], **kw)
    if isinstance(focc, WaveletRows):
        return from_u32_bits(_launch_wm(focc, lanes[0], l32, *lanes[1:],
                                        **kw))
    return from_u32_bits(_launch(focc, lanes[0], l32, *lanes[1:], **kw))


def lf_walk(focc, r0: torch.Tensor, steps: int) -> torch.Tensor:
    """Final rank (int64) of every lane after ``steps`` LF steps."""
    if not _on_cuda(r0):
        return lf_walk_plain(focc, r0, steps)
    _check_range("ranks", r0, focc.n)
    return _go(focc, r0, _steps_i32(torch.full_like(r0, int(steps))))


lf_walk.launches = 0
# the same launches by what a step visits, and by form ("64":
# bwt_lf_walk_w, "_wm": bwt_lf_walk_wm)
LAUNCHES = {"none": 0, "verify": 0, "harvest": 0, "select": 0,
            "locate": 0, "decode": 0,
            "none64": 0, "verify64": 0, "harvest64": 0, "locate64": 0,
            "decode64": 0,
            "none_wm": 0, "verify_wm": 0, "harvest_wm": 0, "locate_wm": 0,
            "decode_wm": 0}


def verify_walk(focc, text: torch.Tensor, r0: torch.Tensor, p0: torch.Tensor,
                seg_len: torch.Tensor) -> torch.Tensor:
    """Per-lane mismatch counts (int64) of the checkbwt walk; ``text`` is
    the densified text as a flat uint8 tensor on the lanes' device (int16
    of uint16 bits on wavelet rows)."""
    if not _on_cuda(r0):
        return verify_walk_plain(focc, text, r0, p0, seg_len)
    tdt = torch.int16 if isinstance(focc, WaveletRows) else torch.uint8
    if text.dtype != tdt or text.device != r0.device \
            or not text.is_contiguous() or text.shape[0] != focc.n:
        raise TypeError("text must be a contiguous %s tensor of n=%d "
                        "symbols on %s" % (tdt, focc.n, r0.device))
    _check_range("ranks", r0, focc.n)
    _check_range("positions", p0, focc.n)
    bad = torch.zeros(len(r0), dtype=torch.int32, device=r0.device)
    _go(focc, r0, _steps_i32(seg_len), p0, text=text, bad=bad)
    return bad.long()


def harvest_walk(focc, r0: torch.Tensor, p0: torch.Tensor,
                 seg_len: torch.Tensor, sarate: int, isarate: int):
    """(SA samples, ISA samples) as int64 tensors, -1 where unvisited.
    On wide rows ``sarate`` is a power of two."""
    if not _on_cuda(r0):
        return harvest_walk_plain(focc, r0, p0, seg_len, sarate, isarate)
    n = focc.n
    _check_range("ranks", r0, n)
    _check_range("positions", p0, n)
    dt = torch.int64 if isinstance(focc, WideOcc) else torch.int32
    sa = torch.full(((n + sarate - 1) // sarate,), -1, dtype=dt,
                    device=r0.device)
    isa = torch.full(((n + isarate - 1) // isarate,), -1, dtype=dt,
                     device=r0.device)
    _go(focc, r0, _steps_i32(seg_len), p0, sarate=sarate, isarate=isarate,
        sa=sa, isa=isa)
    if dt == torch.int64:
        return sa, isa
    return _samples(sa), _samples(isa)


def locate_walk(focc, r0: torch.Tensor, rate: int):
    """(rank, steps) as int64 tensors: each lane LF-steps from r0 to the
    first rank that is a multiple of ``rate`` (any positive integer), as
    far as that takes; steps is -1 for a lane still walking after n steps,
    which a lane on a BWT's LF cycle never reaches.  One launch of the
    kernel's locate visit on the card."""
    rate = int(rate)
    if rate < 1:
        raise ValueError("the locate walk takes a rate >= 1")
    if not _on_cuda(r0):
        return locate_walk_plain(focc, r0, rate)
    _check_range("ranks", r0, focc.n)
    steps = torch.empty(len(r0), dtype=torch.int64, device=r0.device)
    # past n only rank 0 is a multiple: the same walk as at rate n
    r = _go(focc, r0, None, steps=steps, rate=min(rate, max(focc.n, 1)))
    return r, steps


def decode_walk(focc, r0: torch.Tensor, p0: torch.Tensor,
                seg_len: torch.Tensor, base: int, length: int):
    """text[base : base + length] (circular) as ``decode_walk_plain``
    gives it: uint8, int16 (uint16 bits) on wavelet rows.  One launch of
    the kernel's decode visit on the card."""
    n = focc.n
    if not (0 <= int(base) < max(n, 1) and 0 <= int(length) <= n):
        raise ValueError("decode takes 0 <= base < n and length <= n")
    if not _on_cuda(r0):
        return decode_walk_plain(focc, r0, p0, seg_len, base, length)
    _check_range("ranks", r0, n)
    _check_range("positions", p0, n)
    dt = torch.int16 if isinstance(focc, WaveletRows) else torch.uint8
    out = torch.zeros(int(length), dtype=dt, device=r0.device)
    _go(focc, r0, _steps_i32(seg_len), p0, dec=out, base=int(base),
        out_len=int(length))
    return out


def select_walk(focc, bitwords: torch.Tensor, r0: torch.Tensor, cap: int):
    """(hit rank, steps) as int64 tensors, steps -1 where no rank with a
    set bit came within ``cap`` steps; ``bitwords`` holds one bit per
    rank as uint32 words in an int32 tensor of at least n / 32 + 1
    words.  Narrow rank rows only (n < 2^32).  On the card the wrapper
    builds the bitmap's summary (``select_summary``) and launches the
    select kernel once."""
    if not _on_cuda(r0):
        return select_walk_plain(focc, bitwords, r0, cap)
    if isinstance(focc, (WideOcc, WaveletRows)):
        raise ValueError("the select walk runs on narrow rank rows")
    if bitwords.dtype != torch.int32 or bitwords.device != r0.device \
            or not bitwords.is_contiguous() \
            or bitwords.shape[0] * 32 <= focc.n:
        raise TypeError("bitwords must be a contiguous int32 tensor of "
                        "more than n=%d bits on %s" % (focc.n, r0.device))
    _check_range("ranks", r0, focc.n)
    r32, = _lanes([r0], False)
    r_hit, steps = _launch_select(focc, bitwords, select_summary(bitwords),
                                  r32, cap, select_blocks(r0.device,
                                                          len(r0)))
    return from_u32_bits(r_hit), steps.long()


def reset_launch_counts() -> None:
    lf_walk.launches = 0
    for k in LAUNCHES:
        LAUNCHES[k] = 0
