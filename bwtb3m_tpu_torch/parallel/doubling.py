"""Sharded circular suffix sorting over the ranks of a process group.

Port of ``bwtb3m_tpu/parallel/doubling.py``: the text, the rank vector
and the sort waves are sharded over the ranks; every doubling round is
one distributed multi-key sort (``parallel/blocksort.py``) plus a
dense-rank renumbering whose only cross-rank traffic is one boundary
exchange and an all_gather of one scalar per rank, and a second
distributed sort takes the new ranks back to position order.  The
reference's ``lax.while_loop`` is a Python loop here; its exit test (the
dense rank of the last real entry, ``real_max_dense``) reaches every
rank through a broadcast, so all ranks leave the loop together.

Layout (D ranks, K per rank, N = D K slots):

- by-position tensors: rank s owns positions [sK, (s+1)K);
- by-rank tensors (sa, sorted keys, bwt): rank s owns sorted indices
  [sK, (s+1)K).

A text whose length n does not divide by D takes pad slots [n, N) holding
a copy of text[0 : N-n], so packed keys near the wrap read their circular
successors; pads carry the key 0xFFFFFFFF with a flag column, then their
slot id as rank, and sort after every real entry.  The pad stays at least
as wide as the packed key (the reference asserts this; where its choice
of K would break it, at a length shorter than one key per rank, K grows
until the pad is wide enough, which only adds pad slots).
``rank[(i+k) mod N]`` (``_roll_rank``) comes from the two ranks that
hold it, by two exchanges, in place of the reference's composition of
power-of-two shifts; the result is the same.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops.doubling import _pack_width
from .blocksort import (distributed_sort, exchange, exclusive_shard_offset,
                        fetch_prev_shard_last)
from .mesh import Mesh, all_gather, broadcast

_PAD_KEY = 0xFFFFFFFF


def _shift(mesh: Mesh, x: torch.Tensor, m: int) -> torch.Tensor:
    """Rank s receives rank (s + m) mod D's ``x``."""
    D = mesh.world
    got, = exchange(mesh, [x], [(i, (i - m) % D) for i in range(D)])
    return got


def _roll_rank(mesh: Mesh, rank_local: torch.Tensor, k: int, K: int
               ) -> torch.Tensor:
    """rank[(i + k) mod N] for this rank's positions i: the tail of rank
    (s + q)'s shard and the head of rank (s + q + 1)'s, q = k // K."""
    q, rem = divmod(k, K)
    a = _shift(mesh, rank_local[rem:], q)
    if rem == 0:
        return a
    return torch.cat([a, _shift(mesh, rank_local[:rem], q + 1)])


def _dense_ranks_from_sorted(mesh: Mesh, keys) -> torch.Tensor:
    """Global 0-based dense ranks of globally sorted key columns."""
    flags_mid = keys[0][1:] != keys[0][:-1]
    for kcol in keys[1:]:
        flags_mid |= kcol[1:] != kcol[:-1]
    first_neq = torch.zeros((), dtype=torch.bool, device=keys[0].device)
    for kcol in keys:
        first_neq |= kcol[0] != fetch_prev_shard_last(mesh, kcol)
    if mesh.rank == 0:
        first_neq = torch.zeros_like(first_neq)
    incl = torch.cumsum(torch.cat([first_neq.reshape(1), flags_mid]), 0)
    return exclusive_shard_offset(mesh, incl[-1]) + incl


def _real_max_dense(mesh: Mesh, nr_s: torch.Tensor, n: int, K: int) -> int:
    """Dense rank of the last real entry (global sorted index n - 1),
    the same on every rank."""
    cand = nr_s[(n - 1) % K].reshape(1).clone()
    return int(broadcast(mesh, cand, (n - 1) // K)[0])


def _sort_rotations(mesh: Mesh, sym_local: torch.Tensor, K: int, n: int,
                    sigma: int):
    """(sa, rank_by_pos, bwt) shards of the N = D K slots (module
    docstring); n real positions in slots [0, n)."""
    D, s = mesh.world, mesh.rank
    N = D * K
    pad = N - n
    bits = max(1, math.ceil(math.log2(max(2, sigma))))
    # the halo reaches one shard to the right: the packed width is capped
    w = min(_pack_width(sigma), K)
    assert pad == 0 or pad >= w
    dev = sym_local.device
    sym_local = sym_local.long()
    pos = s * K + torch.arange(K, dtype=torch.int64, device=dev)
    is_pad = pos >= n

    # ---- initial key: w symbols packed, halo from the next shard ----
    ext = torch.cat([sym_local, _shift(mesh, sym_local[:w], 1)])
    key0 = torch.zeros(K, dtype=torch.int64, device=dev)
    for j in range(w):
        key0 = ((key0 << bits) | ext[j:j + K]) & _PAD_KEY
    # pads sort strictly after every real entry: the largest key plus a
    # flag column (a real packed key can itself be 0xFFFFFFFF)
    key0 = torch.where(is_pad, _PAD_KEY, key0)
    k_s, f_s, p_s = distributed_sort(mesh, (key0, is_pad.long(), pos), 3)
    r_s = _dense_ranks_from_sorted(mesh, (k_s, f_s))
    _pp, rank = distributed_sort(mesh, (p_s, r_s), 1)
    rank = torch.where(is_pad, pos, rank)
    done = _real_max_dense(mesh, r_s, n, K) == n - 1
    sa = p_s

    def roll2(rank, k):
        """rank at real position (slot + k) mod n for real slots."""
        if pad == 0:
            return _roll_rank(mesh, rank, k, K)
        a = _roll_rank(mesh, rank, k % N, K)
        b = _roll_rank(mesh, rank, (k + pad) % N, K)
        return torch.where(pos < n - k, a, b)

    k = w
    while not done and k < n:
        r1s, r2s, sa = distributed_sort(mesh, (rank, roll2(rank, k), pos), 3)
        nr_s = _dense_ranks_from_sorted(mesh, (r1s, r2s))
        _pp, rank = distributed_sort(mesh, (sa, nr_s), 1)
        rank = torch.where(is_pad, pos, rank)
        done = _real_max_dense(mesh, nr_s, n, K) == n - 1
        k *= 2

    # ---- BWT: route each rank's request to the owner of sym[(sa-1) mod n]
    # targets are a permutation of the N slots (pads ask for their own
    # slot), so sorted by target a rank holds its own positions in order
    target = torch.where(pos < n, torch.where(sa == 0, n - 1, sa - 1), pos)
    _tp, req_rank = distributed_sort(mesh, (target, pos), 1)
    _rr, bwt = distributed_sort(mesh, (req_rank, sym_local), 1)
    return sa, rank, bwt


def _slots_per_rank(n: int, D: int, sigma: int) -> int:
    """K: n / D, or for a ragged n the reference's choice, grown until
    the pad covers the packed width the kernel uses (module docstring)."""
    if n % D == 0:
        return n // D
    w = min(_pack_width(int(sigma)), (n + D - 1) // D)
    K = -(-(n + w) // D)
    while D * K - n < min(_pack_width(int(sigma)), K):
        K += 1
    return K


def suffix_array_sharded(symbols, sigma: int, mesh: Mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded circular suffix sort and BWT of the host text ``symbols``
    (every rank passes the whole text): this rank's shards of

    - sa[r]    by rank, the circular suffix array,
    - rank[i]  by position, dense rotation ranks (ties on periodic texts;
               sa breaks them by position),
    - bwt[r]   by rank, sym[(sa[r] - 1) mod n],

    int64 tensors of K slots on the mesh's device; slots at or past n
    (global index) are pads."""
    D = mesh.world
    n = len(symbols)
    if n >= 2 ** 31:
        raise ValueError(
            "int32 rank space supports n < 2^31; the int64 rank path is a "
            "planned extension")
    K = _slots_per_rank(n, D, sigma)
    sym = np.asarray(symbols, dtype=np.int32)
    if D * K != n:
        sym = np.concatenate([sym, np.resize(sym, D * K - n)])
    sym_local = torch.from_numpy(np.ascontiguousarray(
        sym[mesh.rank * K:(mesh.rank + 1) * K])).to(mesh.device)
    return _sort_rotations(mesh, sym_local, K, n, int(sigma))


def sharded_bwt(symbols, sigma: int, mesh: Mesh):
    """Host wrapper: numpy (sa int64, rank int64, bwt int32) of the whole
    text on every rank."""
    n = len(symbols)
    out = []
    for t in suffix_array_sharded(symbols, sigma, mesh):
        out.append(all_gather(mesh, t).reshape(-1)[:n].cpu().numpy())
    sa, rank, bwt = out
    return sa.astype(np.int64), rank.astype(np.int64), bwt.astype(np.int32)
