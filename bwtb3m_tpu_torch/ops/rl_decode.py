"""Narrow RLB1 ``.bwt`` files to dense symbols on the device: the CUDA
kernel, its wrapper, its plain version, and the file load that feeds
them.

``decode_rl_u8`` launches ``bwt_rl_decode_u8`` (``csrc/rl_decode.cu``)
for CUDA tensors and runs ``decode_rl_u8_plain``, the same function in
torch (``repeat_interleave`` over the same block layout), for CPU
tensors; any other device raises.  One call decodes a slab: whole
blocks of the file, back to back, as ``io/rl.py`` writes them (the whole
payload, in ``decode_file``), each symbol written through ``table``, the
dense id of each byte symbol (-1: not in the alphabet), so that the
densify is done in the same pass.  It
replaces no TPU kernel: the JAX package decodes the file on the host.
The arguments:

    payload     uint8 [nbytes]: the file's bytes from offset ``base``
    ends        int64 [nblk + 1]: the absolute offset of each block of
                the slab, then the end of the last
    b0          the file's index of the slab's first block, which
                decodes to the symbols [b0 * block_size, ...)
    n, block_size   the file's symbol count and block size
    table       int16 [256]
    out         uint8 [>= n]: the dense symbols, written in place
    err         int32 [1]: or-ed with ``ERRORS``' bits where a block is
                malformed; the output is then unspecified

``err`` is read by the caller, once, after the last launch: a launch
does not sync.  Every launch is counted in ``decode_rl_u8.launches``.

``decode_file`` decodes a whole file through it: the payload is read
with ``preadv`` into one pinned host buffer (PyTorch's pinned-memory
cache keeps it for the next load of the same size), copied to the card
and decoded in one launch.  The decoded symbols never exist on the host.
A ring of two pinned 32 MiB slabs that overlapped the read of one slab
with the copy and decode of the last was measured against this and won
no more than the runs' spread: the read of the file bounds both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .lf_walk import _ptr, _stream

HEADER_BYTES = 30          # io/rl.py's header, before the first block
ESCAPE = 255
# the kernel's error bits
ERRORS = {1: "a block's header or arrays lie outside its bytes",
          2: "a block's escapes do not match its count of long runs",
          4: "a block's run lengths do not sum to its length",
          8: "a symbol outside the alphabet of the count table"}


def _fault(err: torch.Tensor, bit: int) -> None:
    err[0] = err[0] | bit


def _le(payload: torch.Tensor, at: torch.Tensor, k: int) -> torch.Tensor:
    """The little-endian unsigned integers of ``k`` bytes at ``at``, as
    int64 (8-byte values of 2^63 or more read negative)."""
    v = torch.zeros_like(at)
    for i in range(k):
        v |= payload[at + i].long() << (8 * i)
    return v


def decode_rl_u8_plain(payload, ends, base: int, b0: int, n: int,
                       block_size: int, table, out, err):
    """The slab's blocks in torch, vectorised over its blocks and runs,
    with the kernel's checks; returns ``out``."""
    nblk = ends.numel() - 1
    if nblk <= 0:
        return out
    dev = payload.device
    at = ends[:-1] - base
    avail = ends[1:] - ends[:-1]
    blen = torch.clamp(n - (b0 + torch.arange(nblk, device=dev))
                       * block_size, max=block_size)
    if bool(((at < 0) | (avail < 8) | (at + avail > payload.numel())).any()):
        _fault(err, 1)
        return out
    nruns, nbig = _le(payload, at, 4), _le(payload, at + 4, 4)
    if bool((8 + 2 * nruns + 8 * nbig > avail).any()):
        _fault(err, 1)
        return out
    blk = torch.repeat_interleave(torch.arange(nblk, device=dev), nruns)
    first = torch.cumsum(nruns, 0) - nruns
    k = torch.arange(len(blk), device=dev) - first[blk]
    sym_at = at[blk] + 8 + k
    sym = payload[sym_at].long()
    len8 = payload[sym_at + nruns[blk]].long()
    esc = (len8 == ESCAPE).long()
    escapes = torch.zeros(nblk, dtype=torch.int64, device=dev).index_add_(
        0, blk, esc)
    if bool((escapes != nbig).any()):
        _fault(err, 2)
        return out
    # each escape's index in its block's table of long runs
    idx = (torch.cumsum(esc, 0) - esc) - (torch.cumsum(escapes, 0)
                                          - escapes)[blk]
    lens = len8.clone()
    hit = esc.bool()
    lens[hit] = _le(payload, (at + 8 + 2 * nruns)[blk][hit] + 8 * idx[hit],
                    8)
    sums = torch.zeros(nblk, dtype=torch.int64, device=dev).index_add_(
        0, blk, lens)
    if bool(((lens < 0) | (lens > blen[blk])).any()) or \
            bool((sums != blen).any()):
        _fault(err, 4)
        return out
    ids = table.long()[sym]
    if bool((ids < 0).any()):
        _fault(err, 8)
        return out
    lo = b0 * block_size
    out[lo:lo + int(blen.sum())] = torch.repeat_interleave(
        ids.to(torch.uint8), lens)
    return out


# ------------------------------------------------------------ CUDA wrapper

def _lib():
    from ._build import load
    return load("rl_decode")


def _check_args(payload, ends, b0: int, n: int, block_size: int, table,
                out, err):
    dev = payload.device
    for name, t, dtype in (("payload", payload, torch.uint8),
                           ("ends", ends, torch.int64),
                           ("table", table, torch.int16),
                           ("out", out, torch.uint8),
                           ("err", err, torch.int32)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
                or t.device != dev:
            raise TypeError("%s must be a contiguous 1-D %s tensor on %s"
                            % (name, dtype, dev))
    nblk = ends.numel() - 1
    if table.numel() != 256 or err.numel() != 1:
        raise ValueError("table holds 256 dense ids and err one word")
    if block_size < 1 or b0 < 0 or nblk < 0 or out.numel() < n \
            or (nblk and (b0 + nblk - 1) * block_size >= n):
        raise ValueError("blocks [%d, %d) of %d symbols lie outside the "
                         "%d symbols of out"
                         % (b0, b0 + nblk, block_size, n))


def decode_rl_u8(payload: torch.Tensor, ends: torch.Tensor, base: int,
                 b0: int, n: int, block_size: int, table: torch.Tensor,
                 out: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """The wrapper of ``bwt_rl_decode_u8``: one launch decodes the slab
    (module docstring).  Returns ``out``; CPU tensors take
    ``decode_rl_u8_plain``."""
    _check_args(payload, ends, b0, n, block_size, table, out, err)
    if payload.device.type == "cpu":
        return decode_rl_u8_plain(payload, ends, base, b0, n, block_size,
                                  table, out, err)
    if payload.device.type != "cuda":
        raise ValueError("no RLB1 decode kernel for device %s"
                         % payload.device)
    with torch.cuda.device(payload.device):   # the launch's own card
        rc = _lib().bwt_rl_decode_u8(
            _ptr(payload), payload.numel(), _ptr(ends), int(base),
            ends.numel() - 1, int(b0), int(block_size), int(n), _ptr(table),
            _ptr(out), _ptr(err), _stream(payload.device))
    decode_rl_u8.launches += 1
    if rc != 0:
        raise RuntimeError("CUDA kernel launch failed: %s (%d)"
                           % (_lib().bwt_error_string(rc).decode(), rc))
    return out


decode_rl_u8.launches = 0


# --------------------------------------------------------------- the file

def _read_into(fd: int, buf: torch.Tensor, offset: int) -> None:
    view = memoryview(buf.numpy())
    got = 0
    while got < len(view):
        k = os.preadv(fd, [view[got:]], offset + got)
        if k <= 0:
            raise ValueError("RLB1 file ends inside its payload")
        got += k


def decode_file(reader, table: torch.Tensor, device):
    """The dense symbols of the narrow RLB1 file that ``reader``
    (``io/rl.py::RLReader``) has open, on ``device``: (uint8 tensor [n],
    payload bytes read).  ``table``: int16 [256], as ``decode_rl_u8``'s.
    Raises ``ValueError`` on a malformed file."""
    device = torch.device(device)
    n, bs = int(reader.n), int(reader.block_size)
    out = torch.empty(n, dtype=torch.uint8, device=device)
    ends = np.append(reader.block_off.astype(np.int64),
                     np.int64(reader.footer_off))
    with open(reader.path, "rb", buffering=0) as f:
        fd = f.fileno()
        if reader.wide or ends[0] < HEADER_BYTES \
                or bool((np.diff(ends) < 0).any()) \
                or ends[-1] > os.fstat(fd).st_size:
            raise ValueError("not a narrow RLB1 file with ordered blocks "
                             "inside it: %s" % reader.path)
        if n == 0:
            return out, 0
        lo, nbytes = int(ends[0]), int(ends[-1] - ends[0])
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        _read_into(fd, buf, lo)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    decode_rl_u8(buf.to(device), torch.from_numpy(ends).to(device), lo, 0,
                 n, bs, table.to(device), out, err)
    code = int(err.item())
    if code:
        raise ValueError("malformed RLB1 file %s: %s" % (
            reader.path, "; ".join(v for b, v in ERRORS.items()
                                   if code & b)))
    return out, nbytes
