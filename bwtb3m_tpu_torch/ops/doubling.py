"""Circular suffix sorting by prefix doubling, in PyTorch.

Port of ``bwtb3m_tpu/ops/doubling.py`` (``_pack_width``,
``_initial_key_pair``, ``suffix_sa_bwt_jax``, ``suffix_array``).  The BWT
is that of the circular text (no terminator).  Each round is one stable
sort of a (rank[i], rank[(i+k) mod n]) key with ties left in position
order, then a cumsum over "key changed" flags re-densifies the ranks:

    round 0:    key = (w symbols at i, w symbols at i+w), packed uint32 words
    round k:    key = (rank[i], rank[(i+k) mod n]),  k = 2w, 4w, ...

The two uint32 halves of a key pack into one int64 for
``torch.sort(stable=True)``: ranks are < 2^31, and the first round's
words, which use all 32 bits, are shifted down by 2^31 before packing so
that signed order is unsigned order.  The loop syncs once per round (the
all-distinct test) and stops when every rank is distinct or k >= n;
periodic texts keep equal rotations tied, ordered by position, exactly as
the reference does.

``BWTB3M_SORT=ls`` selects the reference's tie-compacted variant
(``suffix_array_ls``: rounds over the still-tied rotations only, at
host-chosen bucket sizes, to cut a TPU's per-dispatch cost).  It gives
the same SA, ranks and BWT as the plain doubling, so here it is accepted
and runs this sort (``tests/test_torch_merge_legacy.py`` holds both to
the reference under ``ls``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..util import trace


def _pack_width(sigma: int) -> int:
    """How many symbols fit in a uint32 initial key."""
    bits = max(1, math.ceil(math.log2(max(2, sigma))))
    return max(1, 32 // bits)


def _initial_key(sym: torch.Tensor, sigma: int, w: int,
                 offset: int = 0) -> torch.Tensor:
    """uint32 key (in int64) of w circularly consecutive symbols at
    i + offset, first symbol most significant."""
    bits = max(1, math.ceil(math.log2(max(2, sigma))))
    key = torch.zeros_like(sym)
    for j in range(w):
        key = (key << bits) | torch.roll(sym, -(offset + j))
    return key


def _initial_key_pair(sym: torch.Tensor, sigma: int, w: int):
    """(key_hi, key_lo): packed words of symbols [i, i+w) and [i+w, i+2w)."""
    key_hi = _initial_key(sym, sigma, w)
    return key_hi, torch.roll(key_hi, -w)


def _rerank(sorted_key: torch.Tensor) -> torch.Tensor:
    """Dense ranks along a sorted key: cumsum of "changed" flags."""
    r_s = torch.zeros_like(sorted_key)
    r_s[1:] = (sorted_key[1:] != sorted_key[:-1]).cumsum(0)
    return r_s


def suffix_sa_bwt(sym: torch.Tensor, sigma: int, log=None):
    """(sa, bwt) of the circular text ``sym`` (int64 tensor, n >= 2) on
    its device: ``sa[r]`` is the start of the r-th smallest rotation (ties
    by position), ``bwt[r] = sym[(sa[r] - 1) mod n]``.  ``log`` (a
    ``VerboseLog``) gets the number of sorts and the prefix length they
    resolved."""
    n = sym.shape[0]
    w = _pack_width(sigma)
    key_hi, key_lo = _initial_key_pair(sym, sigma, w)
    key = (key_hi - (1 << 31)) * (1 << 32) + key_lo
    del key_hi, key_lo
    sorted_key, sa = torch.sort(key, stable=True)
    r_s = _rerank(sorted_key)
    del key, sorted_key
    k = min(2 * w, n)
    sorts = 1
    while k < n and int(r_s[-1]) != n - 1:
        rank = torch.empty_like(r_s)
        rank[sa] = r_s
        key = (rank << 32) | torch.roll(rank, -k)
        del rank
        sorted_key, sa = torch.sort(key, stable=True)
        r_s = _rerank(sorted_key)
        del key, sorted_key
        k *= 2
        sorts += 1
    if log is not None:
        log.v("prefix doubling: %d sorts, prefixes of %d symbols compared"
              % (sorts, min(k, n)))
    return sa, sym[torch.where(sa == 0, n - 1, sa - 1)]


def suffix_array(symbols: np.ndarray, sigma: int, device, log=None,
                 bwt_out: Optional[list] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper: (sa int64, isa int64, bwt int32) numpy arrays, the
    sort on ``device``.  ``isa`` is the exact inverse permutation of
    ``sa`` (ties broken by position), built on the host as the reference
    does.  ``bwt_out``, a list, also gets the BWT as a uint8 tensor on
    ``device`` where sigma <= 256 and n >= 2 (the ``.hwt`` writer's
    input)."""
    n = len(symbols)
    if n >= 2 ** 31:
        raise ValueError(
            "single-block doubling supports n < 2^31 (int32 rank space)")
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.int32)
    if n == 1:
        return (np.zeros(1, dtype=np.int64), np.zeros(1, dtype=np.int64),
                np.asarray(symbols, dtype=np.int32))
    with trace.span("engine.sort.device") as sort:
        sym = torch.from_numpy(np.require(symbols, requirements="CW")).to(
            device).long()
        sa_dev, bwt_dev = suffix_sa_bwt(sym, int(sigma), log)
        if bwt_out is not None and sigma <= 256:
            bwt_out.append(bwt_dev.to(torch.uint8))
        sa = sa_dev.cpu().numpy()
        bwt = bwt_dev.to(torch.int32).cpu().numpy()
    with trace.span("engine.sort.host_inverse") as inverse:
        isa = np.zeros(n, dtype=np.int64)
        isa[sa] = np.arange(n, dtype=np.int64)
    if log is not None:
        log.v("suffix sort on %s incl. transfers %.3fs, inverse SA on the "
              "host %.3fs" % (device, sort.seconds, inverse.seconds))
    return sa, isa, bwt
