"""Windowed per-block suffix sorting for the scaled merge engine.

Port of ``bwtb3m_tpu/ops/windowsort.py`` (``_window_order_body``,
``_block_filter``, ``_order_pair``).  A block's suffixes are sorted by
prefix doubling over a lookahead window text[s : s+W) of the circular
text (W = block length + lookahead), treating out-of-window as the
smallest possible tail (pad low) and, where needed, as the largest (pad
high).  The true rotation order lies between the two, so when they agree
on the block's own positions every comparison was decided inside the
window.

Semantics kept exactly:

- symbols are shifted to 1..sigma; pad is 0 (low) or sigma+1 (high)
  (an int16 window holds the uint16 bits of dense ids past 256 symbols,
  an int32 one the ids past 65,536: one symbol a word from there);
- the first sort takes three packed words of ``w = 32 // bits`` symbols
  each, position last (ties stay in position order);
- doubling rounds sort (rank, rank at +k) with ``pad_rank`` -1 (low) or
  W+1 (high) past the window;
- the fast-resolution flag (done and compared length <= lookahead) skips
  the pad-high confirmation sort.

``torch.sort`` takes one key, so the three 32-bit words of the first sort
go through two stable sorts, least significant first: word 3, then words
1 and 2 packed into one int64 (word 1 shifted down by 2^31 so that signed
order is unsigned order).  Doubling keys pack (rank, r2 + 1) into one
int64: the +1 keeps ``pad_rank`` = -1 non-negative.

The reference's ``_window_order_flag`` (a jitted entry with the
lookahead static) has no caller there and is not carried over.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _rerank(changed: torch.Tensor) -> torch.Tensor:
    """Dense ranks along a sorted key from its "changed" flags."""
    r_s = torch.zeros(changed.shape[0] + 1, dtype=torch.int64,
                      device=changed.device)
    torch.cumsum(changed, 0, out=r_s[1:])
    return r_s


def window_order(window: torch.Tensor, sigma: int, pad_high: bool,
                 la: int) -> Tuple[torch.Tensor, bool]:
    """(order of all W window suffixes, fast-resolution flag).

    Suffixes compare non-circularly with out-of-window as -inf
    (``pad_high=False``) or +inf; identical clamped suffixes stay in
    position order.  The flag is set when the doubling finished (all
    ranks distinct) having compared at most ``la`` symbols: then every
    decision between two block suffixes used real text only."""
    W = window.shape[0]
    dev = window.device
    bits = max(1, math.ceil(math.log2(sigma + 2)))
    w = max(1, 32 // bits)
    pad_val = sigma + 1 if pad_high else 0
    u = window.to(torch.int64)
    if window.dtype == torch.int16:       # uint16 bits: dense ids past 256
        u &= 0xFFFF
    u += 1

    def packed_key(offset: int) -> torch.Tensor:
        key = torch.zeros(W, dtype=torch.int64, device=dev)
        for j in range(w):
            o = min(offset + j, W)      # fully past the end: all padding
            key <<= bits
            key[:W - o] |= u[o:]
            key[W - o:] |= pad_val
        return key

    # first sort: three packed words, position last (two stable passes)
    k3 = packed_key(2 * w)
    order = torch.argsort(k3, stable=True)
    k12 = (packed_key(0) - (1 << 31)) << 32
    k12 |= packed_key(w)
    k12_s, idx = torch.sort(k12[order], stable=True)
    del k12
    p_s = order[idx]
    del order, idx
    k3_s = k3[p_s]
    del k3
    changed = (k12_s[1:] != k12_s[:-1]) | (k3_s[1:] != k3_s[:-1])
    del k12_s, k3_s
    r_s = _rerank(changed)
    del changed
    rank = torch.empty(W, dtype=torch.int64, device=dev)
    rank[p_s] = r_s
    pad_rank = W + 1 if pad_high else -1
    k = min(3 * w, max(W, 1))
    done = int(r_s[-1]) == W - 1
    del r_s
    while not done and k < W:
        key = torch.full((W,), pad_rank + 1, dtype=torch.int64, device=dev)
        key[:W - k] = rank[k:] + 1
        key |= rank << 32
        key_s, p_s = torch.sort(key, stable=True)
        del key
        r_s = _rerank(key_s[1:] != key_s[:-1])
        del key_s
        rank[p_s] = r_s
        done = int(r_s[-1]) == W - 1
        del r_s
        k *= 2        # total compared length after this round
    return p_s, bool(done and k <= la)


def block_filter(sa_full: torch.Tensor, block_len: int) -> torch.Tensor:
    """Keep only the block's own positions, in order."""
    return sa_full[sa_full < block_len]


def block_suffix_order(window: torch.Tensor, block_len: int, sigma: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(pad-low order, pad-high order, mismatch count) over the block's
    positions [0, block_len) as window offsets — ``_order_pair`` of the
    reference.  When the pad-low doubling sets the fast flag the pad-high
    sort is skipped: the high order is the low one and the count is 0.
    A count of 0 means the order is the true rotation order."""
    W = window.shape[0]
    lo_sa, fast = window_order(window, sigma, False, W - block_len)
    lo_b = block_filter(lo_sa, block_len)
    del lo_sa
    if fast:
        return lo_b, lo_b, 0
    hi_sa, _ = window_order(window, sigma, True, 0)
    hi_b = block_filter(hi_sa, block_len)
    del hi_sa
    return lo_b, hi_b, int((lo_b != hi_b).sum())
