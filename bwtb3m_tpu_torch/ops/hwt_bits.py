"""The node words of a Huffman-shaped wavelet tree (the ``.hwt``) from a
uint8 BWT on the device: the CUDA kernel, its wrapper and its plain
version.

``hwt_node_words`` launches ``csrc/hwt_bits.cu`` (``bwt_hwt_tile_counts``,
then ``bwt_hwt_node_words``) for a CUDA tensor and runs
``hwt_node_words_plain``, the same function in torch, for a CPU tensor;
any other device raises.  It replaces no TPU kernel: the JAX package
builds the tree on the host (``bwtb3m_tpu/index/wavelet.py``, one gather
of the text per inner node), and so did the port, on one host thread.
The kernel is bound by bytes (the text read, the words written); the
source says how its two passes and its shared-memory buffers meet that.

The arguments:

    bwt      uint8 [n], contiguous: the symbols
    inside   bool [k, 256], 1 <= k <= ``MAX_NODES``: whether symbol s's
             code passes through inner node j
    bits     uint8 [k, 256]: the bit symbol s takes at node j (read only
             where ``inside``)

It returns (words, lengths): ``words`` an int64 tensor on ``bwt``'s
device holding every node's bitvector in node order, LSB-first in u64
words as ``index/bitvector.py::RankBitVector.words`` holds them, each
node from a word boundary, its bits past its length 0; ``lengths`` the
nodes' bit counts, a list of ints.  A call on the card syncs once, to
size the output from the first pass's counts.  Every call that goes to
the card is counted in ``hwt_node_words.launches``.
"""

from __future__ import annotations

import torch

from .lf_walk import _ptr, _stream

MAX_NODES = 16      # the kernel's node bits; index/wavelet.py PER_NODE_MAX
SEGMENT = 1024      # symbols a warp counts (csrc/hwt_bits.cu kSeg)
TILE = 8 * SEGMENT  # symbols a block packs (kTile)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 bits as LSB-first u64 words (int64), the tail zero."""
    pad = -bits.numel() % 64
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    weight = torch.arange(8, device=bits.device)
    by = (bits.view(-1, 8).long() << weight).sum(1).to(torch.uint8)
    return by.view(torch.int64)


def hwt_node_words_plain(bwt: torch.Tensor, inside: torch.Tensor,
                         bits: torch.Tensor):
    """The nodes' words in torch: per node, the bits of its members
    gathered in text order and packed; (words, lengths)."""
    sym = bwt.long()
    inside, bits = inside.to(bwt.device), bits.to(bwt.device)
    parts, lengths = [], []
    for j in range(inside.shape[0]):
        node = bits[j][sym[inside[j][sym]]]
        lengths.append(node.numel())
        parts.append(_pack_words(node))
    return torch.cat(parts), lengths


def _table(inside: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The kernel's symbol table, int32 [256]: bit j whether the symbol
    passes through node j, bit 16 + j the bit it takes there."""
    shift = torch.arange(inside.shape[0], device=inside.device)[:, None]
    member = inside.long()
    one = member & bits.long() & 1
    tab = ((member << shift) | (one << (shift + 16))).sum(0)
    return torch.where(tab >= 1 << 31, tab - (1 << 32), tab).to(torch.int32)


def _check_args(bwt, inside, bits):
    if bwt.dtype != torch.uint8 or bwt.dim() != 1 \
            or not bwt.is_contiguous():
        raise TypeError("bwt must be a contiguous 1-D uint8 tensor")
    if inside.dtype != torch.bool or bits.dtype != torch.uint8:
        raise TypeError("inside must be a bool and bits a uint8 tensor")
    if inside.dim() != 2 or inside.shape != bits.shape \
            or inside.shape[1] != 256 \
            or not 1 <= inside.shape[0] <= MAX_NODES:
        raise ValueError("inside and bits must be [k, 256] tables of 1 to "
                         "%d inner nodes, got %s and %s"
                         % (MAX_NODES, tuple(inside.shape),
                            tuple(bits.shape)))


def _lib():
    from ._build import load
    return load("hwt_bits")


def _raise_on(rc: int) -> None:
    if rc != 0:
        raise RuntimeError("CUDA kernel launch failed: %s (%d)"
                           % (_lib().bwt_error_string(rc).decode(), rc))


def _tile_counts(bwt, tab, k: int) -> torch.Tensor:
    """The first pass: int32 [k, nseg], each node's members in each
    segment of ``SEGMENT`` symbols."""
    nseg = -(-bwt.numel() // TILE) * (TILE // SEGMENT)
    counts = torch.empty(k, nseg, dtype=torch.int32, device=bwt.device)
    _raise_on(_lib().bwt_hwt_tile_counts(_ptr(bwt), bwt.numel(), _ptr(tab),
                                         k, _ptr(counts),
                                         _stream(bwt.device)))
    return counts


def _offsets(counts: torch.Tensor):
    """(offsets int64 [k, nseg + 1], lengths, words): each segment's first
    output bit of each node, the nodes one after another from word
    boundaries; the nodes' bit counts (one sync); the words they take."""
    k, nseg = counts.shape
    offsets = torch.zeros(k, nseg + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[:, 1:] = torch.cumsum(counts, 1, dtype=torch.int64)
    lengths = offsets[:, -1].tolist()
    first, total = [], 0
    for m in lengths:
        first.append(total)
        total += (m + 63) // 64
    offsets += 64 * torch.tensor(first, dtype=torch.int64,
                                 device=counts.device)[:, None]
    return offsets, lengths, total


def _node_words(bwt, tab, k: int, offsets, total: int) -> torch.Tensor:
    """The second pass: the nodes' words, int64 [total]."""
    words = torch.zeros(total, dtype=torch.int64, device=bwt.device)
    _raise_on(_lib().bwt_hwt_node_words(_ptr(bwt), bwt.numel(), _ptr(tab),
                                        k, _ptr(offsets), _ptr(words),
                                        _stream(bwt.device)))
    return words


def hwt_node_words(bwt: torch.Tensor, inside: torch.Tensor,
                   bits: torch.Tensor):
    """The wrapper of ``csrc/hwt_bits.cu`` (module docstring): (words,
    lengths).  CPU tensors take ``hwt_node_words_plain``."""
    _check_args(bwt, inside, bits)
    dev = bwt.device
    if dev.type == "cpu":
        return hwt_node_words_plain(bwt, inside, bits)
    if dev.type != "cuda":
        raise ValueError("no .hwt node-word kernel for device %s" % dev)
    k = inside.shape[0]
    if bwt.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), [0] * k
    if bwt.data_ptr() % 16:
        bwt = bwt.clone()             # the kernel's 16-byte loads
    tab = _table(inside, bits).to(dev)
    with torch.cuda.device(dev):     # the launches' own card
        offsets, lengths, total = _offsets(_tile_counts(bwt, tab, k))
        words = _node_words(bwt, tab, k, offsets, total)
    hwt_node_words.launches += 1
    return words, lengths


hwt_node_words.launches = 0
