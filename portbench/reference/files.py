"""The files of a build as the plain reference writes them, from its own
suffix array, in the formats of ``FORMATS.md``: ``.bwt`` (RLB1), ``.hist``,
``.sa`` / ``.isa`` (sampled arrays), ``.hwt`` (HWT1), and the check of a
``.preisa``.  Plain PyTorch and NumPy; nothing of the program is
imported.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np
import torch

RL_BLOCK = 1 << 16          # symbols per RLB1 block
RL_ESCAPE = 255             # len8 value whose length is in the big table


def _u8(t: torch.Tensor) -> torch.Tensor:
    """The little-endian bytes of a contiguous int tensor."""
    return t.contiguous().view(torch.uint8)


def rlb1_bytes(bwt: torch.Tensor, sigma: int) -> bytes:
    """The RLB1 ``.bwt`` of ``bwt`` (uint8 symbols < ``sigma`` <= 256):
    runs split at every block start, per block ``nruns u32 | nbig u32 |
    syms u8[nruns] | len8 u8[nruns] | big u64[nbig]``, then the footer of
    block offsets and the symbol counts before every block."""
    dev = bwt.device
    n = len(bwt)
    nb = max(1, -(-n // RL_BLOCK))
    mark = torch.ones(n, dtype=torch.bool, device=dev)
    mark[1:] = bwt[1:] != bwt[:-1]
    mark[::RL_BLOCK] = True
    starts = torch.nonzero(mark).squeeze(1)
    del mark
    lens = torch.diff(starts, append=torch.tensor([n], device=dev))
    syms = bwt[starts].to(torch.int64)
    blk = starts // RL_BLOCK
    del starts
    nruns = torch.bincount(blk, minlength=nb)
    big = lens >= RL_ESCAPE
    nbig = torch.bincount(blk[big], minlength=nb)
    size = 8 + 2 * nruns + 8 * nbig
    head = 30
    off = head + torch.cumsum(size, 0) - size
    footer = head + int(size.sum())
    out = torch.zeros(footer + 8 * nb + 8 * (nb + 1) * sigma,
                      dtype=torch.uint8, device=dev)
    out[:head] = torch.tensor(list(struct.pack(
        "<4sBBIQIQ", b"RLB1", 1, 0, sigma, n, RL_BLOCK, footer)),
        dtype=torch.uint8, device=dev)
    eight = torch.arange(8, device=dev)
    bh = torch.stack([nruns, nbig], 1).to(torch.int32)
    out[(off[:, None] + eight).reshape(-1)] = _u8(bh).reshape(-1)
    first = torch.cumsum(nruns, 0) - nruns
    j = torch.arange(len(blk), device=dev) - first[blk]
    at = off[blk] + 8 + j
    out[at] = syms.to(torch.uint8)
    out[at + nruns[blk]] = torch.where(big, RL_ESCAPE, lens).to(torch.uint8)
    del at, j
    bblk = blk[big]
    bfirst = torch.cumsum(nbig, 0) - nbig
    jb = torch.arange(len(bblk), device=dev) - bfirst[bblk]
    at = off[bblk] + 8 + 2 * nruns[bblk] + 8 * jb
    out[(at[:, None] + eight).reshape(-1)] = _u8(lens[big]).reshape(-1)
    counts = torch.bincount(blk * sigma + syms, weights=lens.to(torch.float64),
                            minlength=nb * sigma)
    counts = counts.round().to(torch.int64).reshape(nb, sigma)
    cum = torch.zeros(nb + 1, sigma, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(counts, 0)
    tail = torch.cat([off, cum.reshape(-1)])
    out[footer:] = _u8(tail)
    return out.cpu().numpy().tobytes()


def hist_bytes(text_hist: np.ndarray) -> bytes:
    """``.hist``: the count, then (symbol u64, frequency u64) of every
    symbol that occurs, by symbol."""
    syms = np.flatnonzero(text_hist)
    pairs = np.stack([syms, text_hist[syms]], 1).astype("<u8")
    return struct.pack("<Q", len(syms)) + pairs.tobytes()


def sampled_bytes(rate: int, values: torch.Tensor) -> bytes:
    """``.sa`` / ``.isa``: rate u64, count u64, values u64."""
    v = values.to(torch.int64).cpu().numpy().astype("<u8")
    return struct.pack("<QQ", rate, len(v)) + v.tobytes()


def preisa_wrong(raw: bytes, meta: bytes, isa: torch.Tensor) -> int:
    """How many ways a ``.preisa`` and its ``.preisa.meta`` fail: pairs
    (rank, position) at every position that is a multiple of the
    sampling rate, position 0 among them, each rank the ISA at its
    position, in any order.  Returns the number of wrong or missing
    pairs (a malformed file counts as wrong everywhere)."""
    n = len(isa)
    if len(meta) != 16 or len(raw) % 16:
        return n
    rate, count = struct.unpack("<QQ", meta)
    pairs = np.frombuffer(raw, "<u8").reshape(-1, 2).astype(np.int64)
    want = -(-n // rate) if rate else 0
    if rate < 1 or count != len(pairs) or len(pairs) != want:
        return max(want, len(pairs), 1)
    ranks, pos = pairs[:, 0], pairs[:, 1]
    order = np.argsort(pos, kind="stable")
    pos, ranks = pos[order], ranks[order]
    expect_pos = np.arange(0, n, rate, dtype=np.int64)
    wrong = int((pos != expect_pos).sum())
    if wrong:
        return wrong
    got = torch.from_numpy(ranks).to(isa.device)
    at = torch.from_numpy(expect_pos).to(isa.device)
    return int((isa[at] != got).sum())


def huffman_lengths(hist: dict) -> dict:
    """Code lengths of a Huffman code of ``hist``: the two lightest
    nodes merge first, ties by creation (the leaves in symbol order,
    then the merged nodes)."""
    syms = sorted(s for s, c in hist.items() if c > 0)
    if len(syms) == 1:
        return {syms[0]: 1}
    heap = [(hist[s], i, ("leaf", s)) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    made = len(syms)
    kids = {}
    while len(heap) > 1:
        w1, _, a = heapq.heappop(heap)
        w2, _, b = heapq.heappop(heap)
        node = ("node", made)
        kids[node] = (a, b)
        heapq.heappush(heap, (w1 + w2, made, node))
        made += 1
    lengths, stack = {}, [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if node[0] == "leaf":
            lengths[node[1]] = d
        else:
            stack += [(c, d + 1) for c in kids[node]]
    return lengths


def canonical_codes(lengths: dict) -> dict:
    """Canonical codes: by (length, symbol), each the last plus one,
    shifted left to its length."""
    codes, code, prev = {}, 0, 0
    for s in sorted(lengths, key=lambda s: (lengths[s], s)):
        code <<= lengths[s] - prev
        codes[s] = code
        code += 1
        prev = lengths[s]
    return codes


def trie_nodes(codes: dict, lengths: dict):
    """The inner nodes of the code trie as (prefix, depth), numbered as
    they are made when the codes are inserted in symbol order."""
    nodes = [(0, 0)]
    index = {(0, 0): 0}
    for s in sorted(codes):
        for d in range(1, lengths[s]):
            p = codes[s] >> (lengths[s] - d)
            if (p, d) not in index:
                index[(p, d)] = len(nodes)
                nodes.append((p, d))
    return nodes


def hwt_bytes(bwt: torch.Tensor, sigma: int) -> bytes:
    """The HWT1 ``.hwt`` of ``bwt``: n, the symbols with their code
    lengths and counts, then per inner node of the canonical Huffman
    trie the bits its symbols take there, in text order (nbits u64,
    words u64, LSB first)."""
    hist_t = torch.bincount(bwt.to(torch.int64), minlength=sigma)
    hist = {int(s): int(c) for s, c in enumerate(hist_t.tolist()) if c}
    lengths = huffman_lengths(hist)
    codes = canonical_codes(lengths)
    parts = [b"HWT1", struct.pack("<QI", len(bwt), len(hist))]
    for s in sorted(hist):
        parts.append(struct.pack("<IBQ", s, lengths[s], hist[s]))
    for prefix, depth in trie_nodes(codes, lengths):
        inside = np.zeros(sigma, bool)
        bit = np.zeros(sigma, np.uint8)
        for s in hist:
            ln = lengths[s]
            if ln > depth and codes[s] >> (ln - depth) == prefix:
                inside[s] = True
                bit[s] = (codes[s] >> (ln - depth - 1)) & 1
        sel = bwt[torch.from_numpy(inside).to(bwt.device)[bwt.long()]]
        bits = torch.from_numpy(bit).to(bwt.device)[sel.long()]
        nbits = len(bits)
        padded = torch.zeros(-(-nbits // 64) * 64, dtype=torch.uint8,
                             device=bwt.device)
        padded[:nbits] = bits
        weights = (1 << torch.arange(8, device=bwt.device)).to(torch.uint8)
        packed = (padded.view(-1, 8) * weights).sum(1).to(torch.uint8)
        parts.append(struct.pack("<Q", nbits))
        parts.append(packed.cpu().numpy().tobytes())
    return b"".join(parts)
