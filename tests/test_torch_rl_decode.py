"""The RLB1 decode of ``ops/rl_decode.py`` on the CPU: the plain version
of ``bwt_rl_decode_u8`` and the file load ``decode_file``, against
``native.rl_decode_u8`` and ``RLReader.decode_all`` on files written by
``rl_encode`` (the native writer and the numpy one); the alphabet from
the file's count table against ``np.unique``; malformed payloads; and
the route ``BwtResult.load_focc`` records.  The kernel itself is held to
the plain version in ``tests/test_torch_kernels_cuda.py``."""

import time

import numpy as np
import pytest
import torch

from bwtb3m_tpu_torch import native
from bwtb3m_tpu_torch.engine.result import (BwtResult, clear_caches,
                                            dense_table, footer_alphabet)
from bwtb3m_tpu_torch.io.rl import RLReader, rl_encode
from bwtb3m_tpu_torch.ops import rl_decode
from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
from bwtb3m_tpu_torch.util import trace

torch.set_num_threads(1)


def _runs(rng, lengths, alphabet):
    """Symbols of runs of the given lengths, neighbours never equal."""
    syms = [int(rng.choice(alphabet))]
    for _ in lengths[1:]:
        syms.append(int(rng.choice([a for a in alphabet if a != syms[-1]])))
    return np.repeat(np.array(syms, np.uint8), lengths)


def _text(case):
    rng = np.random.default_rng(len(case))
    if case == "escapes":         # 254, 255, 256, whole blocks, across blocks
        lengths = [254, 255, 256, 1, 1000, 2500, 3, 255, 254, 256, 1000,
                   1, 7001]
        return _runs(rng, lengths + list(rng.integers(1, 4, 500)),
                     [0, 1, 2, 3, 4]), 1000
    if case == "block_1":
        return rng.integers(0, 5, 1001).astype(np.uint8), 1
    if case == "block_7":
        return _runs(rng, list(rng.integers(1, 20, 2000)), [0, 1, 2, 3]), 7
    if case == "block_65536":     # a whole block one run, n ragged
        lengths = [65536, 65536] + list(rng.integers(1, 300, 1500))
        return _runs(rng, lengths, [1, 2, 3, 4]), 65536
    if case == "sparse":          # the alphabet {0, 3, 200}
        return _runs(rng, list(rng.integers(1, 600, 3000)), [0, 3, 200]), 999
    raise ValueError(case)


CASES = ["escapes", "block_1", "block_7", "block_65536", "sparse"]


def _write(tmp_path, case, writer, monkeypatch):
    text, block = _text(case)
    if writer == "numpy":
        monkeypatch.setattr(native, "rl_encode_u8", lambda *a: False)
    path = str(tmp_path / ("%s.bwt" % case))
    rl_encode(path, text, sigma=int(text.max()) + 1, block_size=block)
    return path, text


def _identity(reader):
    return torch.from_numpy(dense_table(reader.symbol_histogram(), None,
                                        dense=False))


@pytest.mark.parametrize("writer", ["native", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_plain_decode_matches_the_host_decoders(tmp_path, monkeypatch,
                                                case, writer):
    path, text = _write(tmp_path, case, writer, monkeypatch)
    with RLReader(path) as r:
        assert (len(text) % r.block_size != 0) == (case != "block_1")
        want = native.rl_decode_u8(path, r.n)
        assert np.array_equal(want, text)
        assert np.array_equal(r.decode_all(), text.astype(np.int32))
        before = rl_decode.decode_rl_u8.launches
        got, nbytes = rl_decode.decode_file(r, _identity(r), "cpu")
        assert rl_decode.decode_rl_u8.launches == before   # the plain one
        assert nbytes == r.footer_off - int(r.block_off[0])
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_slab", [1, 3, 64, 1 << 20])
@pytest.mark.parametrize("case", ["escapes", "block_7", "block_65536"])
def test_plain_decode_of_whole_block_slabs_equals_one_pass(
        tmp_path, monkeypatch, case, per_slab):
    """One call over any run of whole blocks (``b0``, the bytes from
    ``base``) writes those blocks' symbols; slabs of ``per_slab`` blocks
    back to back give what ``decode_file``'s one pass gives."""
    path, text = _write(tmp_path, case, "native", monkeypatch)
    with RLReader(path) as r:
        ends = np.append(r.block_off.astype(np.int64), r.footer_off)
        raw = np.fromfile(path, np.uint8)
        whole, _ = rl_decode.decode_file(r, _identity(r), "cpu")
        out = torch.zeros(r.n, dtype=torch.uint8)
        err = torch.zeros(1, dtype=torch.int32)
        for b0 in range(0, r.nb, per_slab):
            b1 = min(r.nb, b0 + per_slab)
            lo, hi = int(ends[b0]), int(ends[b1])
            rl_decode.decode_rl_u8(torch.from_numpy(raw[lo:hi].copy()),
                                   torch.from_numpy(ends[b0:b1 + 1].copy()),
                                   lo, b0, r.n, r.block_size, _identity(r),
                                   out, err)
    assert int(err) == 0
    assert np.array_equal(whole.numpy(), text)
    assert torch.equal(out, whole)


@pytest.mark.parametrize("case", CASES)
def test_footer_alphabet_is_what_np_unique_gives(tmp_path, monkeypatch,
                                                 case):
    """The alphabet from the count table, and the dense symbols through
    its table, equal the ``np.unique`` route's, symbol map included."""
    path, text = _write(tmp_path, case, "native", monkeypatch)
    with RLReader(path) as r:
        sigma = r.sigma
        hist = r.symbol_histogram()
        got_sigma, symmap = footer_alphabet(hist, sigma, dense=True)
        table = dense_table(hist, symmap, dense=True)
        got, _ = rl_decode.decode_file(r, torch.from_numpy(table), "cpu")
    present = np.unique(text)
    if len(present) < sigma or present[-1] >= len(present):
        remap = np.zeros(max(sigma, int(present[-1]) + 1), np.uint8)
        remap[present] = np.arange(len(present), dtype=np.uint8)
        want, want_sigma, want_map = remap[text], len(present), present
    else:
        want, want_sigma, want_map = text, sigma, None
    assert got_sigma == want_sigma
    if want_map is None:
        assert symmap is None
    else:
        assert symmap.dtype == np.int64 and np.array_equal(symmap, want_map)
    assert np.array_equal(got.numpy(), want)
    assert footer_alphabet(hist, sigma, dense=False) == (sigma, None)


def test_footer_alphabet_edges():
    h = np.array([0, 5, 0, 2], np.uint64)
    sigma, symmap = footer_alphabet(h, 4, dense=True)
    assert sigma == 2 and symmap.tolist() == [1, 3]
    assert dense_table(h, symmap, True)[:5].tolist() == [-1, 0, -1, 1, -1]
    full = np.array([3, 1, 4], np.uint64)
    assert footer_alphabet(full, 3, dense=True) == (3, None)
    assert dense_table(full, None, True)[:4].tolist() == [0, 1, 2, -1]
    # a file whose meta sigma is larger than its symbols: densified
    assert footer_alphabet(full, 5, dense=True)[0] == 3
    assert dense_table(h, None, False)[:5].tolist() == [0, 1, 2, 3, -1]


def _doctor(path, what):
    """Alter one byte of a block of the file: a run length (``len8``), an
    escape made a plain length (``escape``, block 1), a symbol out of the
    alphabet (``symbol``) or the block's run count (``header``; these
    three in the last block, of short runs)."""
    with RLReader(path) as r:
        off = int(r.block_off[1 if what == "escape" else r.nb - 1])
    with open(path, "r+b") as f:
        f.seek(off)
        nruns = int.from_bytes(f.read(4), "little")
        lens = off + 8 + nruns
        f.seek(lens)
        len8 = np.frombuffer(f.read(nruns), np.uint8)
        if what == "len8":
            k = int(np.flatnonzero(len8 < 200)[0])
            at, val = lens + k, int(len8[k]) + 1
        elif what == "escape":
            k = int(np.flatnonzero(len8 == 255)[0])
            at, val = lens + k, 7
        elif what == "symbol":
            at, val = off + 8, 9
        else:
            at, val = off, (nruns + 100_000) & 0xFF
        f.seek(at)
        f.write(bytes([val]))


@pytest.mark.parametrize("what", ["len8", "escape", "symbol", "header"])
def test_a_malformed_payload_raises(tmp_path, monkeypatch, what):
    path, text = _write(tmp_path, "escapes", "native", monkeypatch)
    _doctor(path, what)
    with RLReader(path) as r:
        table = torch.from_numpy(dense_table(
            r.symbol_histogram(), None, dense=True))
        with pytest.raises(ValueError, match="malformed RLB1 file"):
            rl_decode.decode_file(r, table, "cpu")
    if what == "len8":                # the host decoder refuses it too
        assert native.rl_decode_u8(path, len(text)) is None


def test_plain_decode_raises_the_error_bits_of_each_fault(tmp_path,
                                                          monkeypatch):
    """One slab call: a good slab leaves ``err`` 0, a slab whose bytes
    stop short of its last block sets the header bit."""
    path, text = _write(tmp_path, "block_7", "native", monkeypatch)
    with RLReader(path) as r:
        ends = np.append(r.block_off.astype(np.int64), r.footer_off)
        raw = np.fromfile(path, np.uint8)
        b0, b1 = 3, 40
        lo, hi = int(ends[b0]), int(ends[b1])
        args = (torch.from_numpy(ends[b0:b1 + 1].copy()), lo, b0, r.n,
                r.block_size, _identity(r))
        out = torch.zeros(r.n, dtype=torch.uint8)
        err = torch.zeros(1, dtype=torch.int32)
        rl_decode.decode_rl_u8(torch.from_numpy(raw[lo:hi].copy()), *args,
                               out, err)
        assert int(err) == 0
        assert np.array_equal(out.numpy()[b0 * 7:b1 * 7], text[b0 * 7:b1 * 7])
        rl_decode.decode_rl_u8(torch.from_numpy(raw[lo:hi - 1].copy()),
                               *args, out, err)
        assert int(err) == 1
        with pytest.raises(ValueError, match="outside"):
            rl_decode.decode_rl_u8(torch.from_numpy(raw[lo:hi].copy()),
                                   args[0], lo, r.nb, r.n, r.block_size,
                                   args[5], out, err)
        with pytest.raises(TypeError, match="table"):
            rl_decode.decode_rl_u8(torch.from_numpy(raw[lo:hi].copy()),
                                   *args[:5], args[5].int(), out, err)


def test_cpu_load_focc_takes_the_host_route(tmp_path, monkeypatch):
    """On the CPU the rows come from the host route, recorded on the
    decode span, and equal the rows of the ``np.unique`` route."""
    path, text = _write(tmp_path, "sparse", "native", monkeypatch)
    res = BwtResult({"n": len(text), "sigma": 201, "files": {"bwt": path}})
    clear_caches()
    lo = time.time_ns()
    focc, symmap = res.load_focc("cpu")
    recs = {r.name: r for r in trace.records(lo, time.time_ns())}
    clear_caches()
    with RLReader(path) as r:
        payload = r.footer_off - int(r.block_off[0])
    assert recs["index.rows.decode"].attrs == {"route": "host",
                                               "payload_bytes": payload}
    assert {"index.rows.densify", "index.rows.build"} <= set(recs)
    present = np.unique(text)
    remap = np.zeros(256, np.uint8)
    remap[present] = np.arange(len(present))
    want = build_focc_host(remap[text], len(present), "cpu")
    assert np.array_equal(symmap, present)
    assert torch.equal(focc.rows, want.rows) and torch.equal(focc.C, want.C)


def drop_count(path, symbol):
    """Zero ``symbol``'s total in the file's count table, leaving its
    runs in the payload: a footer that does not match its payload."""
    with RLReader(path) as r:
        at = r.footer_off + 8 * r.nb + 8 * (r.nb * r.sigma + symbol)
        assert r.symbol_histogram()[symbol] > 0
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(bytes(8))
    with RLReader(path) as r:
        assert r.symbol_histogram()[symbol] == 0


@pytest.mark.parametrize("case,symbol", [("sparse", 200), ("sparse", 0),
                                         ("block_7", 3)])
def test_host_route_refuses_a_symbol_its_count_table_lacks(
        tmp_path, monkeypatch, case, symbol):
    """The host route takes its alphabet from the count table; a symbol
    in the payload that the table lacks raises, as the device route's
    kernel does, and is never mapped to another symbol."""
    path, text = _write(tmp_path, case, "native", monkeypatch)
    drop_count(path, symbol)
    res = BwtResult({"n": len(text), "sigma": int(text.max()) + 1,
                     "files": {"bwt": path}})
    clear_caches()
    with pytest.raises(ValueError, match="outside the alphabet"):
        res.load_focc("cpu")
    clear_caches()
    with RLReader(path) as r:         # the plain decode with the same table
        hist = r.symbol_histogram()
        table = dense_table(hist, footer_alphabet(hist, r.sigma, True)[1],
                            True)
        with pytest.raises(ValueError, match="outside the alphabet"):
            rl_decode.decode_file(r, torch.from_numpy(table), "cpu")


def test_decode_file_refuses_a_wide_or_disordered_file(tmp_path):
    path = str(tmp_path / "w.bwt")
    rl_encode(path, np.arange(600, dtype=np.int64) % 300, sigma=300)
    with RLReader(path) as r:
        with pytest.raises(ValueError, match="narrow RLB1"):
            rl_decode.decode_file(r, torch.zeros(256, dtype=torch.int16),
                                  "cpu")
    path = str(tmp_path / "d.bwt")
    rl_encode(path, np.arange(5000, dtype=np.uint8) % 4, sigma=4,
              block_size=100)
    with RLReader(path) as r:
        r.block_off[[3, 4]] = r.block_off[[4, 3]]
        with pytest.raises(ValueError, match="ordered blocks"):
            rl_decode.decode_file(r, _identity(r), "cpu")
