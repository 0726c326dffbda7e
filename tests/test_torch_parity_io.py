"""The cases of ``tests/test_io.py``, the port's ``io/`` against the
reference's: every writer's file byte for byte the reference's, every
reader giving the same arrays from either package's file, on the
compact, RL, LZ4 and pac codecs, the sidecar formats, the input types
and the circular slices."""

import importlib

import numpy as np
import pytest

from test_torch_hostlayer import _reference_library

PKGS = ("bwtb3m_tpu", "bwtb3m_tpu_torch")       # reference, port


def both(mod):
    return [importlib.import_module("%s.io.%s" % (p, mod)) for p in PKGS]


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's LZ4 writer takes its native codec, whatever the
    xdist build race left this worker (``test_torch_hostlayer.py``)."""
    with _reference_library(
            lambda: tmp_path_factory.mktemp("ref_native")) as ref:
        yield ref


def _same_bytes(*paths):
    blobs = [open(p, "rb").read() for p in paths]
    assert all(b == blobs[0] for b in blobs), paths


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_compact_roundtrip(tmp_path, bits):
    ref, port = both("compact")
    rng = np.random.default_rng(bits)
    for n in [0, 1, 7, 8, 63, 64, 65, 1000]:
        sym = rng.integers(0, 1 << bits, size=n, dtype=np.int32)
        paths = [str(tmp_path / f"{k}{bits}_{n}.compact") for k in "rp"]
        ref.write_compact(paths[0], sym, bits)
        port.write_compact(paths[1], sym, bits)
        _same_bytes(*paths)
        for mod in (ref, port):
            back, rbits = mod.read_compact(paths[1])
            assert rbits == bits
            np.testing.assert_array_equal(back, sym)


def test_compact_writer_streaming(tmp_path):
    ref, port = both("compact")
    sym = np.random.default_rng(0).integers(0, 8, size=10013, dtype=np.int32)
    paths = [str(tmp_path / f"{k}.compact") for k in "rp"]
    for mod, path in zip((ref, port), paths):
        with mod.CompactArrayWriter(path, 3) as w:
            i = 0
            for chunk in [1, 10, 100, 1000, 5000, 3902, 1000]:
                w.put(sym[i:i + chunk])
                i += chunk
    _same_bytes(*paths)
    back, bits = port.read_compact(paths[1])
    assert bits == 3
    np.testing.assert_array_equal(back, sym)


@pytest.mark.parametrize("sigma", [2, 4, 6, 256, 1000])
def test_rl_roundtrip(tmp_path, sigma):
    ref, port = both("rl")
    rng = np.random.default_rng(sigma)
    runs = rng.integers(0, sigma, size=500)
    lens = rng.geometric(0.02, size=500)
    sym = np.repeat(runs, lens).astype(np.int32)
    paths = [str(tmp_path / f"{k}.bwt") for k in "rp"]
    ref.rl_encode(paths[0], sym, sigma=sigma, block_size=257)
    port.rl_encode(paths[1], sym, sigma=sigma, block_size=257)
    _same_bytes(*paths)
    assert port.RLReader.get_length(paths[1]) == len(sym)
    with port.RLReader(paths[1]) as r, ref.RLReader(paths[1]) as q:
        np.testing.assert_array_equal(r.decode_all(), sym)
        for lo, hi in [(0, 10), (250, 600), (len(sym) - 5, len(sym)), (7, 7)]:
            np.testing.assert_array_equal(r.decode_range(lo, hi), sym[lo:hi])
            np.testing.assert_array_equal(q.decode_range(lo, hi), sym[lo:hi])
        for c in [0, 1, sigma - 1]:
            for i in [0, 1, 256, 257, 258, len(sym) // 2, len(sym)]:
                assert r.rank(c, i) == q.rank(c, i) == int(
                    np.count_nonzero(sym[:i] == c))
        np.testing.assert_array_equal(
            r.symbol_histogram().astype(np.int64),
            np.bincount(sym, minlength=sigma))


def test_rl_iter_runs(tmp_path):
    ref, port = both("rl")
    sym = np.array([1, 1, 1, 2, 2, 0] * 100, dtype=np.int32)
    paths = [str(tmp_path / f"{k}.bwt") for k in "rp"]
    ref.rl_encode(paths[0], sym, sigma=3, block_size=7)
    port.rl_encode(paths[1], sym, sigma=3, block_size=7)
    _same_bytes(*paths)
    with port.RLReader(paths[1]) as r, ref.RLReader(paths[1]) as q:
        runs = list(r.iter_runs())
        assert runs == list(q.iter_runs())
    np.testing.assert_array_equal(
        np.concatenate([[s] * l for s, l in runs]), sym)
    for (s1, _), (s2, _) in zip(runs, runs[1:]):
        assert s1 != s2


def test_lz4_roundtrip(tmp_path, ref_native):
    ref, port = both("lz4io")
    rng = np.random.default_rng(1)
    for data in [b"", b"a", b"abcabcabcabc" * 100,
                 bytes(rng.integers(0, 256, size=5000, dtype=np.uint8)),
                 bytes(rng.integers(0, 4, size=70000, dtype=np.uint8))]:
        paths = [str(tmp_path / f"{k}.lz4") for k in "rp"]
        ref.write_lz4_stream(paths[0], data, block_size=1 << 12)
        port.write_lz4_stream(paths[1], data, block_size=1 << 12)
        _same_bytes(*paths)
        assert port.read_lz4_stream(paths[0]) == data
        assert ref.read_lz4_stream(paths[1]) == data


def test_pac_roundtrip(tmp_path):
    ref, port = both("pac")
    rng = np.random.default_rng(2)
    for n in [1, 3, 4, 5, 8, 1001]:
        codes = rng.integers(0, 4, size=n, dtype=np.int32)
        paths = [str(tmp_path / f"{k}.pac") for k in "rp"]
        ref.write_pac(paths[0], codes)
        port.write_pac(paths[1], codes)
        _same_bytes(*paths)
        np.testing.assert_array_equal(port.read_pac(paths[0]), codes)


def test_formats_roundtrip(tmp_path):
    ref, port = both("formats")
    hist = {0: 5, 3: 10, 200: 1}
    ranks = np.array([5, 1, 9], dtype=np.int64)
    poss = np.array([0, 64, 128], dtype=np.int64)
    vals = np.arange(17, dtype=np.int64) * 3
    for k, mod in zip("rp", (ref, port)):
        mod.write_hist(str(tmp_path / f"{k}.hist"), hist)
        mod.write_preisa(str(tmp_path / f"{k}.preisa"), ranks, poss, 64)
        mod.write_sampled_array(str(tmp_path / f"{k}.sa"), 32, vals)
    for ext in (".hist", ".preisa", ".preisa.meta", ".sa"):
        _same_bytes(tmp_path / ("r" + ext), tmp_path / ("p" + ext))
    assert port.read_hist(str(tmp_path / "r.hist")) == hist
    r, p, rate = port.read_preisa(str(tmp_path / "r.preisa"))
    np.testing.assert_array_equal(r, ranks)
    np.testing.assert_array_equal(p, poss)
    assert rate == 64
    rate, back = port.read_sampled_array(str(tmp_path / "r.sa"))
    assert rate == 32
    np.testing.assert_array_equal(back, vals)


def test_input_types(tmp_path):
    ref, port = both("inputtypes")
    _rpac, ppac = both("pac")
    (tmp_path / "x.bytes").write_bytes(b"banana")
    ppac.write_pac(str(tmp_path / "x.pac"),
                   np.array([0, 1, 2, 3, 0], dtype=np.int32))
    (tmp_path / "x.txt").write_text("héllo")
    for itype, name in (("bytestream", "x.bytes"), ("pacterm", "x.pac"),
                        ("utf-8", "x.txt")):
        got = port.parse_input_type(itype).load(str(tmp_path / name))
        want = ref.parse_input_type(itype).load(str(tmp_path / name))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    sym, sigma = port.parse_input_type("pacterm").load(
        str(tmp_path / "x.pac"))
    np.testing.assert_array_equal(sym, [1, 2, 3, 4, 1, 0])
    assert sigma == 5


def test_circular_slices():
    ref, port = both("inputtypes")
    t = np.arange(10)
    for mod in (ref, port):
        np.testing.assert_array_equal(mod.circular_slice(t, 8, 4),
                                      [8, 9, 0, 1])
        np.testing.assert_array_equal(mod.circular_reverse_slice(t, 1, 4),
                                      [1, 0, 9, 8])
