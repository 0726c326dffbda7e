"""The ``.hwt`` node words (``ops/hwt_bits.py``) on the CPU: the plain
version against the host route's bits (``index/wavelet.py::_node_bits``
packed by ``RankBitVector``) over alphabets of 1, 2, 5 and 17 symbols
(1 to 16 inner nodes), uniform and skewed, at lengths around a word and
around the kernel's tile; the kernel's symbol table and offsets; a tree
made through ``RankBitVector.from_words`` against the JAX package's
``HuffmanWaveletTree``, byte for byte; the route a CPU build takes, and
the inputs the engine keeps on the host.
The kernel itself runs in ``tests/test_torch_kernels_cuda.py``."""

import filecmp

import numpy as np
import pytest
import torch

from bwtb3m_tpu.index.wavelet import HuffmanWaveletTree as JaxHwt
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.index import wavelet
from bwtb3m_tpu_torch.index.bitvector import RankBitVector
from bwtb3m_tpu_torch.index.huffman import HuffmanTree
from bwtb3m_tpu_torch.ops import hwt_bits
from bwtb3m_tpu_torch.util import trace

TILE = hwt_bits.TILE


def _text(nsym: int, n: int, skew: bool, seed: int) -> np.ndarray:
    """n symbols over ``nsym`` byte values spread over 0..255, each of
    them present where n allows; ``skew``: geometric counts."""
    rng = np.random.default_rng(seed)
    alphabet = np.sort(rng.choice(256, nsym, replace=False))
    if skew:
        p = 0.5 ** np.arange(nsym)
        idx = rng.choice(nsym, n, p=p / p.sum())
    else:
        idx = rng.integers(0, nsym, n)
    idx[:min(n, nsym)] = np.arange(min(n, nsym))
    return alphabet[idx].astype(np.uint8)


def _tables(text: np.ndarray):
    """The tree of ``text`` and its node tables, padded to 256 symbols."""
    uniq, cnt = np.unique(text, return_counts=True)
    tree = HuffmanTree({int(s): int(c) for s, c in zip(uniq, cnt)})
    codes, lengths = tree.code_arrays(int(max(tree.symbols)) + 1)
    prefixes, depths = wavelet._node_paths(tree)
    inside, bit = wavelet._node_tables(codes, lengths, prefixes, depths)
    pad = ((0, 0), (0, 256 - inside.shape[1]))
    return tree, np.pad(inside, pad), np.pad(bit, pad)


def _host_words(text, inside, bit):
    """Each node's words as the host route packs them."""
    parts = wavelet._node_bits(text, inside, bit)
    return [RankBitVector(np.concatenate(p)).words for p in parts]


@pytest.mark.parametrize("n", [1, 63, 64, 65, TILE - 1, TILE + 1])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("nsym", [1, 2, 5, 17])
def test_plain_words_equal_the_host_route(nsym, skew, n):
    text = _text(nsym, n, skew, seed=nsym * 1000 + n)
    tree, inside, bit = _tables(text)
    if nsym == 17 and n >= 17:
        assert tree.num_inner == wavelet.PER_NODE_MAX
    words, lengths = hwt_bits.hwt_node_words_plain(
        torch.from_numpy(text), torch.from_numpy(inside),
        torch.from_numpy(bit))
    want = _host_words(text, inside, bit)
    assert lengths == [int(inside[j][text].sum()) for j in range(len(want))]
    got = words.numpy().view(np.uint64)
    at = 0
    for j, w in enumerate(want):
        assert len(w) == (lengths[j] + 63) // 64
        assert np.array_equal(got[at:at + len(w)], w), j
        at += len(w)
    assert at == len(got)


def test_wrapper_on_a_cpu_tensor_takes_the_plain_version():
    text = _text(5, 3 * TILE + 7, True, seed=3)
    _tree, inside, bit = _tables(text)
    args = [torch.from_numpy(a) for a in (text, inside, bit)]
    before = hwt_bits.hwt_node_words.launches
    words, lengths = hwt_bits.hwt_node_words(*args)
    assert hwt_bits.hwt_node_words.launches == before
    want, want_len = hwt_bits.hwt_node_words_plain(*args)
    assert torch.equal(words, want) and lengths == want_len


@pytest.mark.parametrize("what", ["bwt dtype", "bwt shape", "inside dtype",
                                  "bits dtype", "shapes differ", "257 wide",
                                  "no node", "17 nodes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    bwt = torch.zeros(100, dtype=torch.uint8)
    inside = torch.ones(4, 256, dtype=torch.bool)
    bits = torch.zeros(4, 256, dtype=torch.uint8)
    err = TypeError
    if what == "bwt dtype":
        bwt = bwt.int()
    elif what == "bwt shape":
        bwt = bwt.view(10, 10)
    elif what == "inside dtype":
        inside = inside.to(torch.uint8)
    elif what == "bits dtype":
        bits = bits.bool()
    else:
        err = ValueError
        k, width = {"shapes differ": (4, 256), "257 wide": (4, 257),
                    "no node": (0, 256), "17 nodes": (17, 256)}[what]
        inside = torch.ones(k, width, dtype=torch.bool)
        if what != "shapes differ":
            bits = torch.zeros(k, width, dtype=torch.uint8)
        else:
            bits = torch.zeros(3, 256, dtype=torch.uint8)
    with pytest.raises(err):
        hwt_bits.hwt_node_words(bwt, inside, bits)


@pytest.mark.parametrize("n", [1, 65, TILE + 1, 5 * TILE - 3])
def test_offsets_place_each_segment_and_node(n):
    """The glue between the kernel's passes, on counts made here: each
    segment of a node starts where the segments before it end, each node
    on a word boundary after the one before it."""
    text = _text(5, n, True, seed=n)
    _tree, inside, bit = _tables(text)
    seg = hwt_bits.SEGMENT
    nseg = -(-n // TILE) * (TILE // seg)
    member = inside[:, np.r_[text, np.zeros(nseg * seg - n, np.uint8)]]
    member[:, n:] = False
    counts = member.reshape(len(inside), nseg, seg).sum(2)
    offsets, lengths, total = hwt_bits._offsets(
        torch.from_numpy(counts.astype(np.int32)))
    _w, want = hwt_bits.hwt_node_words_plain(
        torch.from_numpy(text), torch.from_numpy(inside),
        torch.from_numpy(bit))
    assert lengths == want
    first = np.cumsum([0] + [(m + 63) // 64 for m in want])
    assert total == first[-1]
    off = offsets.numpy()
    assert np.array_equal(off[:, 0], 64 * first[:-1])
    assert np.array_equal(np.diff(off, axis=1), counts)


def test_kernel_table_holds_membership_and_bit():
    text = _text(17, 5000, True, seed=9)
    _tree, inside, bit = _tables(text)
    tab = hwt_bits._table(torch.from_numpy(inside),
                          torch.from_numpy(bit)).numpy().view(np.uint32)
    for j in range(inside.shape[0]):
        assert np.array_equal((tab >> j) & 1, inside[j])
        assert np.array_equal((tab >> (16 + j)) & 1, inside[j] & bit[j])


def test_tree_from_words_writes_the_reference_bytes(tmp_path):
    """Nodes made from the plain version's words through ``from_words``
    give the ``.hwt`` of the JAX package's tree, byte for byte."""
    for kind, text in (("single", np.full(300, 65, np.uint8)),
                       ("two", _text(2, 1000, False, 1)),
                       ("dna", _text(5, 2 * TILE + 3, True, 2)),
                       ("seventeen", _text(17, 5000, True, 4))):
        tree, inside, bit = _tables(text)
        words, lengths = hwt_bits.hwt_node_words_plain(
            torch.from_numpy(text), torch.from_numpy(inside),
            torch.from_numpy(bit))
        words = words.numpy().view(np.uint64)
        nodes, at = [], 0
        for m in lengths:
            nw = (m + 63) // 64
            nodes.append(RankBitVector.from_words(m, words[at:at + nw]))
            at += nw
        got = wavelet.HuffmanWaveletTree(tree, len(text), nodes)
        got.write(str(tmp_path / ("p_%s.hwt" % kind)))
        JaxHwt.build(text.astype(np.int32)).write(
            str(tmp_path / ("j_%s.hwt" % kind)))
        assert filecmp.cmp(tmp_path / ("p_%s.hwt" % kind),
                           tmp_path / ("j_%s.hwt" % kind), shallow=False)
        assert np.array_equal(got.decode_all(), text)


def test_from_words_refuses_a_wrong_word_count():
    with pytest.raises(ValueError):
        RankBitVector.from_words(65, np.zeros(1, np.uint64))
    bv = RankBitVector.from_words(65, np.array([5, 1], np.uint64))
    assert bv.rank1(65) == 3 and bv.get(64) == 1


def test_build_with_the_callers_histogram_equals_its_own(tmp_path):
    text = _text(5, 20_000, True, seed=5)
    uniq, cnt = np.unique(text, return_counts=True)
    hist = {int(s): int(c) for s, c in zip(uniq, cnt)}
    wavelet.HuffmanWaveletTree.build(text).write(str(tmp_path / "a.hwt"))
    wavelet.HuffmanWaveletTree.build(text, hist=hist).write(
        str(tmp_path / "b.hwt"))
    assert filecmp.cmp(tmp_path / "a.hwt", tmp_path / "b.hwt",
                       shallow=False)


def test_cpu_build_writes_the_hwt_by_the_host_route(tmp_path):
    """``compute_bwt(bwtonly=0)`` on the CPU: the span ``engine.hwt``
    (inside the log's ``write .hwt``) reads ``route=host``, and the
    ``.hwt`` is the tree of the ``.bwt``'s symbols."""
    inp = tmp_path / "t.bin"
    text = _text(4, 5000, False, seed=6)
    inp.write_bytes(np.frombuffer(b"ACGT", np.uint8)[
        np.searchsorted(np.unique(text), text)].tobytes())
    t0 = trace.records()[-1].end_ns if trace.records() else 0
    res = compute_bwt(BwtOptions(input_path=str(inp), device="cpu",
                                 verbose=0))
    spans = [r for r in trace.records(t0) if r.name == "engine.hwt"]
    assert [r.attrs.get("route") for r in spans] == ["host"]
    tree = wavelet.HuffmanWaveletTree.read(res.meta["files"]["hwt"])
    assert tree.route == "host" and tree.n == 5000


@pytest.mark.parametrize("nsym,sigma,device", [
    (18, 256, "cuda"), (200, 256, "cuda"), (5, 300, "cuda"), (5, 256, "cpu")])
def test_hwt_symbols_keep_the_host_array_off_the_card_route(nsym, sigma,
                                                           device):
    """``engine/api.py::_hwt_symbols`` hands the tree the host BWT where
    the card route cannot take it (more than 17 symbols present, symbols
    past a byte, or no CUDA device), and lets go of the sort's device
    BWT; nothing touches a card."""
    from bwtb3m_tpu_torch.engine.api import _hwt_symbols
    text = _text(nsym, 10_000, False, seed=nsym)
    hist = np.bincount(text, minlength=sigma)
    kept = [object()]
    assert _hwt_symbols(text, hist, torch.device(device), kept) is text
    assert kept == []
