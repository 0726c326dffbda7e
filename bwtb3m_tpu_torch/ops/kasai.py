"""The word-window Kasai walk of PLCP: the CUDA kernel, its wrapper and
its plain version.

``kasai_walk`` launches ``bwt_kasai_plcp`` (``csrc/kasai.cu``), the port
of ``bwtb3m_tpu/lcp/plcp.py::_kasai_chunk2_impl``, for CUDA tensors and
runs ``kasai_plain``, the same step in torch, lock-step over the lanes,
for CPU tensors; any other device raises.  Both take an optional step
cap, as the reference's chunk takes ``steps``, and return the carried
``(plcp, p, l)``, so that a walk can be stopped and compared mid-way.

The arrays, for the positions [a, a + slab) of a text of n < 2^32
symbols:

    words  int32 [ceil(n / spw) + 1]: the text as uint32 words of
           LSB-first symbols, spw = 8 nibbles (bits=4) or 4 bytes
           (bits=8), and one pad word (``lcp/plcp.py::_pack_text_words``)
    phi    int32 [slab]: Phi[a + i] = SA[ISA[a + i] - 1] (uint32 bits)
    p0     int: SA[0], the one position of rank 0 (the reference reads
           ISA at every step only to find it)
    plcp   int32 [>= slab]: PLCP[a + i] (uint32 bits), written in place
    p, l, pend  int64 [L]: lane i owns positions [p[i], pend[i]), with
           a <= p and pend <= a + slab, and carries l[i]

A lane that reaches ``pend`` writes nothing more into ``plcp`` (the
reference sends such writes to a drop slot at ``slab``, as the plain
version does in a copy of its own).  ``taken``,
an int32 tensor [L] where given, receives the steps each lane took (what
a measurement of the walk counts its work by).  Every launch is counted
in ``kasai_walk.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .focc import as_u32_bits, from_u32_bits
from .focc_bp import popcount32
from .lf_walk import _ptr


def _spec(bits: int):
    """(symbols->words shift, in-word index mask, bits->symbols shift)."""
    if bits not in (4, 8):
        raise ValueError("bits is 4 (nibble windows) or 8 (byte windows)")
    return (3, 7, 2) if bits == 4 else (2, 3, 3)


def kasai_plain(words: torch.Tensor, phi: torch.Tensor, p0: int,
                plcp: torch.Tensor, p: torch.Tensor, l: torch.Tensor,
                pend: torch.Tensor, n: int, a: int, bits: int,
                steps: Optional[int] = None, taken=None):
    """The walk in torch, step for step as ``_kasai_chunk2_impl``: at
    most ``steps`` steps (None: until every lane reaches its ``pend``).
    A position has a predecessor (the reference's ISA[p] != 0) unless it
    is ``p0``.  Returns (plcp, p, l); ``plcp`` (and ``taken``) are
    written in place."""
    wsh, wmsk, sym_sh = _spec(bits)
    slab = phi.shape[0]
    p, l, pend = p.long(), l.long(), pend.long()
    # the reference's drop slot at ``slab`` takes the lanes that do not
    # commit, so a step writes without a mask (and without a host sync)
    out = torch.cat([plcp[:slab], plcp.new_zeros(1)])

    def at(arr, pos):
        return from_u32_bits(arr[torch.clamp(pos - a, max=slab - 1)])

    def win(idx):
        wi = idx >> wsh
        sh = (idx & wmsk) * bits
        w0, w1 = from_u32_bits(words[wi]), from_u32_bits(words[wi + 1])
        # in int64 the shift by 32 at an aligned index leaves no bits
        return (w0 >> sh) | ((w1 << (32 - sh)) & 0xFFFFFFFF)

    def wrap(x):
        return torch.where(x >= n, x - n, x)

    q = at(phi, p)
    done = 0
    count = torch.zeros_like(p)
    while steps is None or done < steps:
        active = p < pend
        if steps is None and done % 64 == 0 and not bool(active.any()):
            break
        count += active
        has_prev = p != p0
        pl = torch.where(active, wrap(p + l), 0)
        ql = torch.where(active, wrap(q + l), 0)
        x = win(pl) ^ win(ql)
        k = popcount32(((x & -x) - 1) & 0xFFFFFFFF) >> sym_sh
        k = torch.minimum(torch.minimum(k, n - pl),
                          torch.minimum(n - ql, n - l))
        extend = active & has_prev & (k >= 1)
        commit = active & ~extend
        out[torch.where(commit, p - a, slab)] = as_u32_bits(
            torch.where(has_prev, l, 0))
        l = torch.where(extend, l + k,
                        torch.where(commit & ~has_prev, 0,
                                    torch.where(commit & (l > 0), l - 1, l)))
        p = torch.where(commit, p + 1, p)
        q = torch.where(commit, at(phi, p), q)
        done += 1
    plcp[:slab] = out[:slab]
    if taken is not None:
        taken.copy_(count)
    return plcp, p, l


# ------------------------------------------------------------ CUDA wrapper

def _lib():
    from ._build import load
    return load("kasai")


def _check_args(words, phi, plcp, p, pend, n: int, a: int, bits: int):
    """What the kernel reads and writes must lie inside the tensors."""
    slab = phi.shape[0]
    for name, t in (("words", words), ("phi", phi), ("plcp", plcp)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != p.device:
            raise TypeError("%s must be a contiguous 1-D int32 tensor on %s"
                            % (name, p.device))
    if plcp.shape[0] < slab:
        raise ValueError("plcp holds at least the slab's %d positions"
                         % slab)
    if not 0 < n < 1 << 32 or not 0 <= a < n:
        raise ValueError("the walk takes 0 <= a < n < 2^32")
    spw = 32 // bits
    if words.shape[0] < (n + spw - 1) // spw + 1:
        raise ValueError("words hold the text's %d symbols and a pad word"
                         % n)
    if len(p) and (int(p.min()) < a or int(pend.max()) > a + slab
                   or int(pend.max()) > n):
        raise ValueError("a lane's positions lie outside the slab "
                         "[%d, %d)" % (a, a + slab))


def kasai_walk(words: torch.Tensor, phi: torch.Tensor, p0: int,
               plcp: torch.Tensor, p: torch.Tensor, l: torch.Tensor,
               pend: torch.Tensor, n: int, a: int, bits: int,
               steps: Optional[int] = None, taken=None):
    """The wrapper of ``bwt_kasai_plcp``: one launch runs every lane to
    its ``pend`` (or ``steps`` steps).  Returns (plcp, p, l), int64 p and
    l; ``plcp`` (and ``taken``) are written in place.  CPU tensors take
    ``kasai_plain``."""
    if p.device.type == "cpu":
        return kasai_plain(words, phi, p0, plcp, p, l, pend, n, a, bits,
                           steps, taken)
    if p.device.type != "cuda":
        raise ValueError("no Kasai kernel for device %s" % p.device)
    _spec(bits)
    _check_args(words, phi, plcp, p, pend, n, a, bits)
    if not 0 <= int(p0) < n:
        raise ValueError("p0 = SA[0] lies in [0, n)")
    if taken is not None and (taken.dtype != torch.int32
                              or taken.shape != p.shape
                              or not taken.is_contiguous()
                              or taken.device != p.device):
        raise TypeError("taken must be a contiguous int32 tensor of the "
                        "lanes' shape on %s" % p.device)
    p32 = as_u32_bits(p.long()).contiguous()
    l32 = as_u32_bits(l.long()).contiguous()
    e32 = as_u32_bits(pend.long()).contiguous()
    if len(p32) == 0:
        return plcp, p.long(), l.long()
    rc = _lib().bwt_kasai_plcp(
        _ptr(words), _ptr(phi), int(p0), _ptr(plcp), _ptr(p32), _ptr(l32),
        _ptr(e32), _ptr(taken), len(p32), int(n), int(a), phi.shape[0],
        int(bits), -1 if steps is None else int(steps),
        ctypes.c_void_p(torch.cuda.current_stream(p.device).cuda_stream))
    kasai_walk.launches += 1
    if rc != 0:
        raise RuntimeError("CUDA kernel launch failed: %s (%d)"
                           % (_lib().bwt_error_string(rc).decode(), rc))
    return plcp, from_u32_bits(p32), from_u32_bits(l32)


kasai_walk.launches = 0


def kasai_inputs_from_jax(words, phi, p0, plcp, p, l, pend, device="cpu"):
    """The reference's walk state (numpy views of its uint32 jax arrays:
    ``words``, ``phi``, ``plcp``, ``p``, ``l``, ``pend``; ``p0`` = SA[0]
    in place of its ISA) as this module's arguments on ``device``: the
    arrays as int32 tensors of the same bits, the lanes as int64."""
    def bits32(x):
        return torch.from_numpy(
            np.ascontiguousarray(x, np.uint32).view(np.int32).copy()).to(
                device)

    def lanes(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    return (bits32(words), bits32(phi), int(p0), bits32(plcp),
            lanes(p), lanes(l), lanes(pend))
