"""The plain reference of the suffix order: prefix doubling in plain
PyTorch (sorts, gathers, cumulative sums; no kernel of the program).

The texts of the benchmark end in a unique smallest terminator, so the
order of their rotations is the order of their suffixes, and doubling
over rotations (indices mod n) gives the suffix array.  Runs on any
torch device: on the card after the measured window, on the CPU in the
tests.
"""

from __future__ import annotations

import torch


def _dense_ranks(keys: torch.Tensor):
    """(order, rank of each index, number of distinct keys): the
    stable sort of ``keys`` and each key's rank among the distinct
    ones."""
    sk, order = torch.sort(keys, stable=True)
    step = torch.ones_like(sk, dtype=torch.int64)
    step[0] = 0
    step[1:] = (sk[1:] != sk[:-1]).to(torch.int64)
    del sk
    g = torch.cumsum(step, 0)
    rank = torch.empty_like(g)
    rank[order] = g
    return order, rank, int(g[-1]) + 1


def suffix_array(text: torch.Tensor, sigma: int,
                 max_depth: int = 0) -> torch.Tensor:
    """The suffix array (int64) of ``text`` (symbols < ``sigma``, a
    unique smallest last symbol).  With ``max_depth`` > 0 the rotations
    are ordered by their first ``max_depth`` symbols at most (rounded up
    to the doubling's next step) and ties by position: a shortened sort,
    the benchmark's control."""
    n = len(text)
    t = text.to(torch.int64)
    bits = max(1, (sigma - 1).bit_length())
    k = max(1, min(n, 62 // bits))
    key = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in range(k):
        key = (key << bits) | torch.roll(t, -j)
    del t
    order, rank, distinct = _dense_ranks(key)
    del key
    h = k
    while distinct < n and not (max_depth and h >= max_depth):
        key = (rank << 32) | torch.roll(rank, -h)
        del order
        order, rank, distinct = _dense_ranks(key)
        del key
        h *= 2
    if distinct < n:
        # ties left by a shortened sort go by position
        idx = torch.arange(n, dtype=torch.int64, device=text.device)
        order = torch.sort((rank << 32) | idx).indices
    return order


def inverse(sa: torch.Tensor) -> torch.Tensor:
    isa = torch.empty_like(sa)
    isa[sa] = torch.arange(len(sa), dtype=sa.dtype, device=sa.device)
    return isa


def bwt_of(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """The last column: the symbol before each rotation, in order."""
    n = len(text)
    return text[(sa - 1) % n]
