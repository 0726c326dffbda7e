"""Distributed multi-key sort over the ranks: block merge-split networks.

Port of ``bwtb3m_tpu/parallel/blocksort.py``, the communication core of
the sharded suffix sort.  Every rank holds K elements, kept sorted
locally; a compare-exchange between two partners is a merge-split: each
sorts the 2K union and the lower partner keeps the lower half.  By the
0-1 principle over sorted blocks, a bitonic network (world a power of
two, log^2 D steps) or D odd-even rounds (any world size) sort globally:
rank s then holds global sorted positions [sK, (s+1)K), the reference's
layout.

``exchange`` is the counterpart of ``lax.ppermute``: one
``batch_isend_irecv`` of paired ``P2POp``s; a rank that sends to itself
keeps its data, and an idle rank of an odd-even round sends nothing.  On
a staged mesh (ranks sharing a card over gloo) the exchange goes through
host copies.

The keys are int64 columns of values in [0, 2^32).  A local sort packs
two keys into one int64, (a - 2^31) 2^32 + b (no overflow, and signed
order is the pair's order), and sorts a third key,
the position tie-break, by a second stable sort before it.  The callers'
composite keys are globally unique, so any correct sort gives the
reference's order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather


def exchange(mesh: Mesh, tensors: Sequence[torch.Tensor], perm
             ) -> List[torch.Tensor]:
    """``perm``: (source, destination) pairs forming a permutation of the
    ranks.  This rank sends ``tensors`` to its destination and returns
    what its source sent (of the same shapes and dtypes)."""
    me = mesh.rank
    dst = dict(perm)[me]
    src = {d: s for s, d in perm}[me]
    if dst == me and src == me:
        return list(tensors)
    send = [t.cpu().contiguous() if mesh.staged else t.contiguous()
            for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, dst, mesh.group) for t in send]
           + [dist.P2POp(dist.irecv, t, src, mesh.group) for t in recv])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if mesh.staged:
        return [t.to(mesh.device) for t in recv]
    return recv


def local_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts ``keys`` (first most significant)
    lexicographically: keys packed in pairs, one stable sort per pair from
    the least significant pair up."""
    order = None
    for i in reversed(range(0, len(keys), 2)):
        pair = keys[i:i + 2]
        v = pair[0] if len(pair) == 1 else (
            (pair[0] - (1 << 31)) * (1 << 32) + pair[1])
        if order is None:
            order = torch.sort(v, stable=True).indices
        else:
            order = order[torch.sort(v[order], stable=True).indices]
    return order


def _merge_split(cols: torch.Tensor, received: torch.Tensor, num_keys: int,
                 keep_low: bool) -> torch.Tensor:
    """The lower or upper K columns of the sorted union of two sorted
    [C, K] blocks."""
    K = cols.shape[1]
    both = torch.cat([cols, received], dim=1)
    order = local_order(list(both[:num_keys]))
    keep = order[:K] if keep_low else order[K:]
    return both[:, keep]


def _partner_table(D: int, parity: int) -> List[int]:
    """partner(i) for one odd-even round; identity where idle."""
    part = list(range(D))
    for i in range(0 if parity == 0 else 1, D - 1, 2):
        part[i], part[i + 1] = i + 1, i
    return part


def merge_split_round(mesh: Mesh, cols: torch.Tensor, parity: int,
                      num_keys: int) -> torch.Tensor:
    """One odd-even compare-exchange round over locally sorted [C, K]
    blocks."""
    part = _partner_table(mesh.world, parity)
    s = mesh.rank
    if part[s] == s:
        return cols
    received, = exchange(mesh, [cols], list(enumerate(part)))
    return _merge_split(cols, received, num_keys, s < part[s])


def _bitonic_merge_split(mesh: Mesh, cols: torch.Tensor, j: int, k: int,
                         num_keys: int) -> torch.Tensor:
    """One bitonic comparator step: rank s exchanges with s ^ j; the pair
    keeps (low, high) halves oriented by bit k of the lower index."""
    s = mesh.rank
    partner = s ^ j
    received, = exchange(mesh, [cols],
                         [(i, i ^ j) for i in range(mesh.world)])
    keep_low = (s < partner) == ((s & k) == 0)
    return _merge_split(cols, received, num_keys, keep_low)


def distributed_sort(mesh: Mesh, arrs: Sequence[torch.Tensor],
                     num_keys: int) -> List[torch.Tensor]:
    """Globally sort this rank's int64 columns (each [K], K equal on all
    ranks) by their first ``num_keys``; returns this rank's columns of
    the global order (global sorted positions [sK, (s+1)K))."""
    cols = torch.stack([a.long() for a in arrs])
    cols = cols[:, local_order(list(cols[:num_keys]))]
    D = mesh.world
    if D & (D - 1) == 0:
        k = 2
        while k <= D:
            j = k // 2
            while j >= 1:
                cols = _bitonic_merge_split(mesh, cols, j, k, num_keys)
                j //= 2
            k *= 2
    else:
        for t in range(D):
            cols = merge_split_round(mesh, cols, t % 2, num_keys)
    return list(cols.unbind(0))


def exclusive_shard_offset(mesh: Mesh, local_total: torch.Tensor) -> int:
    """Sum of ``local_total`` (a one-element tensor) over the ranks below
    this one."""
    totals = all_gather(mesh, local_total.reshape(1).long())
    return int(totals[:mesh.rank].sum())


def fetch_prev_shard_last(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The last element of the previous rank's ``x`` (rank 0 receives rank
    D-1's; callers mask it)."""
    D = mesh.world
    got, = exchange(mesh, [x[-1:]], [(i, (i + 1) % D) for i in range(D)])
    return got[0]
