"""The port's own host layer against the reference package's.

``bwtb3m_tpu_torch`` keeps its own copies of the reference's JAX-free
host modules (``io/``, ``native/``, ``util/``).  For seeded numpy inputs
the copies must give byte-identical files and equal arrays: the RLB1
codec, the sidecar formats, the input-type loaders, the compact / pac /
lz4 / fasta readers and writers, and the native entry points.  A file
written by one package loads in the other.  The port's native library
builds into ``bwtb3m_tpu_torch/build/`` under a per-process temporary
name, so concurrent first uses all end with a loadable library.
"""

import contextlib
import gzip
import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("bwtb3m_tpu", "bwtb3m_tpu_torch")       # reference, port


def both(mod):
    return [importlib.import_module("%s.%s" % (p, mod)) for p in PKGS]


def _syms(n, sigma, seed, runs=False):
    rng = np.random.default_rng(seed)
    if runs:        # long runs, as a BWT of repetitive text has
        vals = rng.integers(0, sigma, max(1, n // 7))
        lens = rng.integers(1, 40, len(vals))
        return np.repeat(vals, lens)[:n].astype(np.int64)
    return rng.integers(0, sigma, n).astype(np.int64)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@contextlib.contextmanager
def _reference_library(private_dir):
    """The reference's ``native`` module with a library of its own.

    The reference builds its library into one fixed
    ``_bwtb3m_native.so.tmp`` beside its source; xdist workers that
    import it at once race on that file, and a worker that loses gets
    ``get_lib() is None`` for the rest of its life, so its writers take
    their Python fallbacks (other lz4 bytes, no ``decode_all_u8``).  When
    this process has no library, the reference builds one under
    ``private_dir()`` (its ``.tmp`` then lies there too, where no other
    worker writes); its attributes are restored on exit.  A
    ``BWTB3M_NO_NATIVE`` in the environment (the reference's switch to
    its fallbacks, which reproduces a lost race) is set aside for the
    build."""
    ref = importlib.import_module("bwtb3m_tpu.native")
    if ref.get_lib() is not None:
        yield ref
        return
    if shutil.which("g++") is None:
        pytest.skip("no g++: the reference's native library cannot be "
                    "built here")
    saved = (ref._SO, ref._tried, ref._lib)
    no_native = os.environ.pop("BWTB3M_NO_NATIVE", None)
    ref._SO = os.path.join(str(private_dir()), "_bwtb3m_native.so")
    ref._tried, ref._lib = False, None
    try:
        assert ref.get_lib() is not None, "the reference's g++ build failed"
        yield ref
    finally:
        ref._SO, ref._tried, ref._lib = saved
        if no_native is not None:
            os.environ["BWTB3M_NO_NATIVE"] = no_native


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The comparisons with the reference's native path run against a
    library, whatever the xdist build race left this worker."""
    with _reference_library(
            lambda: tmp_path_factory.mktemp("ref_native")) as ref:
        yield ref


@pytest.mark.parametrize("sigma,n,runs,block", [
    (4, 10000, True, 4096), (4, 5000, False, 65536), (200, 7000, True, 1000),
    (256, 3000, False, 512), (1, 100, True, 64), (300, 2000, True, 256),
    (5000, 3000, False, 1024), (4, 0, False, 64)])
def test_rl_codec_byte_identical_and_cross_loads(tmp_path, sigma, n, runs,
                                                 block, ref_native):
    ref, port = both("io.rl")
    syms = _syms(n, sigma, sigma + n, runs)
    pr, pp = str(tmp_path / "ref.bwt"), str(tmp_path / "port.bwt")
    ref.rl_encode(pr, syms, sigma=sigma, block_size=block)
    port.rl_encode(pp, syms, sigma=sigma, block_size=block)
    assert _bytes(pr) == _bytes(pp)
    # each package decodes the other's file
    np.testing.assert_array_equal(port.rl_decode(pr), syms)
    np.testing.assert_array_equal(ref.rl_decode(pp), syms)
    assert port.RLReader.get_length(pr) == n == ref.RLReader.get_length(pp)
    with ref.open_bwt(pp) as a, port.open_bwt(pr) as b:
        np.testing.assert_array_equal(a.symbol_histogram(),
                                      b.symbol_histogram())
        if n:
            lo, hi = n // 3, n // 3 + min(n // 2, 700)
            np.testing.assert_array_equal(a.decode_range(lo, hi),
                                          b.decode_range(lo, hi))
            np.testing.assert_array_equal(b.decode_range(lo, hi),
                                          syms[lo:hi])
            c = int(syms[n // 2])
            for i in (0, 1, n // 2, n):
                assert a.rank(c, i) == b.rank(c, i) \
                    == int((syms[:i] == c).sum())
        ua, ub = a.decode_all_u8(), b.decode_all_u8()
        assert (ua is None) == (ub is None)
        if ua is not None:
            np.testing.assert_array_equal(ua, ub)


def test_rl_numpy_encoder_matches_native(tmp_path, monkeypatch):
    # the port's numpy encoder (taken when the native library is missing)
    # writes the same bytes as its native writer and as the reference
    ref, port = both("io.rl")
    native = importlib.import_module("bwtb3m_tpu_torch.native")
    syms = _syms(9000, 4, 11, True)
    a, b, c = (str(tmp_path / x) for x in "abc")
    port.rl_encode(a, syms, sigma=4, block_size=1000)
    monkeypatch.setattr(native, "rl_encode_u8", lambda *k, **kw: False)
    port.rl_encode(b, syms, sigma=4, block_size=1000)
    ref.rl_encode(c, syms, sigma=4, block_size=1000)
    assert _bytes(a) == _bytes(b) == _bytes(c)


def test_rlh_files_are_refused_by_name(tmp_path):
    """RLH1 files (refused by name before the codec was ported) open by
    their magic in both packages: each opens the other's file and reads
    the same symbols, histogram and ranks."""
    ref, port = both("io.rl")
    ref_rlh, port_rlh = both("io.rlh")
    syms = _syms(5000, 300, 8, runs=True)
    a, b = str(tmp_path / "a.bwt"), str(tmp_path / "b.bwt")
    ref_rlh.rlh_encode(a, syms, sigma=300, block_size=1000)
    port_rlh.rlh_encode(b, syms, sigma=300, block_size=1000)
    assert _bytes(a) == _bytes(b)
    for mod, path in ((ref, b), (port, a)):
        with mod.open_bwt(path) as r:
            np.testing.assert_array_equal(r.decode_all(), syms)
            np.testing.assert_array_equal(
                r.symbol_histogram().astype(np.int64),
                np.bincount(syms, minlength=300))
            assert r.rank(7, 2500) == int(np.count_nonzero(
                syms[:2500] == 7))


def test_sidecar_formats_byte_identical_and_cross_load(tmp_path):
    ref, port = both("io.formats")
    rng = np.random.default_rng(3)
    ranks = np.sort(rng.choice(10 ** 6, 500, replace=False)).astype(np.int64)
    pos = rng.permutation(500).astype(np.int64) * 2048
    vals = rng.integers(0, 2 ** 40, 300)
    hist = {int(k): int(v) for k, v in zip(rng.choice(256, 20, False),
                                           rng.integers(1, 10 ** 9, 20))}
    meta = {"format": "bwtb3m_tpu/v1", "n": 12345, "sigma": 4,
            "files": {"bwt": "x.bwt", "hist": "x.hist"}}
    out = {}
    for name, m in (("ref", ref), ("port", port)):
        d = tmp_path / name
        d.mkdir()
        m.write_hist(str(d / "h"), hist)
        m.write_preisa(str(d / "p"), ranks, pos, 2048)
        m.write_sampled_array(str(d / "s"), 32, vals)
        m.write_meta(str(d / "m"), meta)
        out[name] = {f: _bytes(str(d / f)) for f in "hpsm"}
    assert out["ref"] == out["port"]
    for writer, reader in (("ref", port), ("port", ref)):
        d = tmp_path / writer
        assert reader.read_hist(str(d / "h")) == hist
        r, p, rate = reader.read_preisa(str(d / "p"))
        np.testing.assert_array_equal(r, ranks)
        np.testing.assert_array_equal(p, pos)
        assert rate == 2048
        rate, v = reader.read_sampled_array(str(d / "s"))
        assert rate == 32
        np.testing.assert_array_equal(v, vals)
        assert reader.read_meta(str(d / "m")) == meta
    arr = rng.integers(0, 7, 1000)
    assert ref.hist_from_array(arr) == port.hist_from_array(arr)


def _write_inputs(tmp_path):
    """One text per input type, written by the reference's writers."""
    rcompact, _ = both("io.compact")
    rpac, _ = both("io.pac")
    rlz4, _ = both("io.lz4io")
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 4099).astype(np.uint8)
    raw = np.frombuffer(b"ACGT", np.uint8)[codes]
    paths = {}
    paths["bytestream"] = str(tmp_path / "t.bin")
    raw.tofile(paths["bytestream"])
    paths["compactstream"] = str(tmp_path / "t.compact")
    rcompact.write_compact(paths["compactstream"], codes, 2)
    paths["pac"] = paths["pacterm"] = str(tmp_path / "t.pac")
    rpac.write_pac(paths["pac"], codes)
    paths["lz4"] = str(tmp_path / "t.lz4")
    rlz4.write_lz4_stream(paths["lz4"], raw.tobytes(), block_size=1000)
    paths["utf-8"] = str(tmp_path / "t.txt")
    with open(paths["utf-8"], "w", encoding="utf-8") as f:
        f.write("".join(chr(int(x)) for x in rng.integers(0x20, 0x3000, 700)))
    return paths


def test_input_type_loaders_equal(tmp_path):
    ref, port = both("io.inputtypes")
    paths = _write_inputs(tmp_path)
    assert sorted(ref._REGISTRY) == sorted(port._REGISTRY)
    for name in sorted(set(c.name for c in port._REGISTRY.values())):
        a, sa = ref.parse_input_type(name).load(paths[name])
        b, sb = port.parse_input_type(name).load(paths[name])
        assert sa == sb and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for name in ("bytestream", "compactstream", "pac", "pacterm"):
        spill = str(tmp_path / ("spill_" + name))
        a = ref.parse_input_type(name).load_bounded(paths[name], spill + "r")
        b = port.parse_input_type(name).load_bounded(paths[name], spill + "p")
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert a[1] == b[1]
    with pytest.raises(ValueError, match="unknown inputtype"):
        port.parse_input_type("fastq")
    t = np.arange(10)
    for fn in ("circular_slice", "circular_reverse_slice"):
        np.testing.assert_array_equal(getattr(ref, fn)(t, 7, 6),
                                      getattr(port, fn)(t, 7, 6))


def test_compact_pac_lz4_writers_byte_identical(tmp_path, ref_native):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    wide = rng.integers(0, 32, 777).astype(np.uint8)
    data = np.frombuffer(b"ACGT", np.uint8)[np.repeat(codes, 3)].tobytes()
    files = {}
    for pkg, (compact, pac, lz4io) in zip(
            ("ref", "port"),
            zip(both("io.compact"), both("io.pac"), both("io.lz4io"))):
        d = tmp_path / pkg
        d.mkdir()
        compact.write_compact(str(d / "c2"), codes, 2)
        compact.write_compact(str(d / "c5"), wide, 5)
        with compact.CompactArrayWriter(str(d / "cw"), 5) as w:
            w.put(wide[:300])
            w.put_one(int(wide[300]))
            w.put(wide[301:])
        pac.write_pac(str(d / "pac"), codes)
        lz4io.write_lz4_stream(str(d / "lz4"), data, block_size=700)
        files[pkg] = {f: _bytes(str(d / f))
                      for f in ("c2", "c5", "cw", "pac", "lz4")}
        assert files[pkg]["c5"] == files[pkg]["cw"]
    assert files["ref"] == files["port"]
    (rc, pc), (rp, pp), (rl, pl) = (both("io.compact"), both("io.pac"),
                                    both("io.lz4io"))
    for writer, compact, pac, lz4io in (("ref", pc, pp, pl),
                                        ("port", rc, rp, rl)):
        d = tmp_path / writer
        got, bits = compact.read_compact(str(d / "c5"))
        np.testing.assert_array_equal(got, wide)
        assert bits == 5 and compact.compact_length(str(d / "c2")) == 1001
        np.testing.assert_array_equal(pac.read_pac(str(d / "pac")), codes)
        np.testing.assert_array_equal(pac.read_pac(str(d / "pac"), shift=1),
                                      codes + 1)
        assert lz4io.read_lz4_stream(str(d / "lz4")) == data
    blob = pl.lz4_compress_block(data)
    assert blob == rl.lz4_compress_block(data)
    assert pl.lz4_decompress_block(blob, len(data)) == data


def test_fasta_readers_equal(tmp_path):
    ref, port = both("io.fasta")
    rng = np.random.default_rng(8)
    recs = [("seq%d some text" % i,
             "".join("ACGTN"[x] for x in rng.integers(0, 5, 50 + 37 * i)))
            for i in range(4)]
    fa = "".join(">%s\n%s\n" % (h, "\n".join(
        s[i:i + 60] for i in range(0, len(s), 60))) for h, s in recs)
    fq = "".join("@%s\n%s\n+\n%s\n" % (h, s, "I" * len(s)) for h, s in recs)
    p_fa, p_gz, p_fq = (str(tmp_path / x) for x in ("a.fa", "a.fa.gz",
                                                    "a.fq"))
    with open(p_fa, "w") as f:
        f.write(fa)
    with gzip.open(p_gz, "wt") as f:
        f.write(fa)
    with open(p_fq, "w") as f:
        f.write(fq)
    want = list(ref.iter_fasta(p_fa))
    assert len(want) == 4
    assert list(port.iter_fasta(p_fa)) == want == list(port.iter_fasta(p_gz))
    assert list(port.iter_fastq(p_fq)) == list(ref.iter_fastq(p_fq))
    codes = rng.integers(0, 4, 33).astype(np.uint8)
    np.testing.assert_array_equal(ref.reverse_complement_codes(codes),
                                  port.reverse_complement_codes(codes))


def test_bits_and_serial_equal():
    import io as _io
    rbits, pbits = both("io.bits")
    rser, pser = both("util.serial")
    rng = np.random.default_rng(4)
    vals = rng.integers(1, 2 ** 20, 500).astype(np.uint64)
    outs = []
    for bits, ser in ((rbits, rser), (pbits, pser)):
        buf = _io.BytesIO()
        for w, v in (("write_u64", 2 ** 64 - 1), ("write_u32", 2 ** 31 + 3),
                     ("write_u16", 65535), ("write_u8", 200)):
            getattr(ser, w)(buf, v)
        ser.write_u64_array(buf, vals)
        ser.write_number_map(buf, {3: 9, 2 ** 40: 1})
        code, nbits = bits.gamma_encode(vals)
        outs.append((buf.getvalue(), bits.pack_bitstream(code), nbits))
    assert outs[0] == outs[1]
    blob, packed, nbits = outs[0]
    for bits, ser in ((rbits, rser), (pbits, pser)):     # the other's bytes
        f = _io.BytesIO(blob)
        assert (ser.read_u64(f), ser.read_u32(f), ser.read_u16(f),
                ser.read_u8(f)) == (2 ** 64 - 1, 2 ** 31 + 3, 65535, 200)
        np.testing.assert_array_equal(ser.read_u64_array(f, len(vals)), vals)
        assert ser.read_number_map(f) == {3: 9, 2 ** 40: 1}
        got = bits.gamma_decode(bits.unpack_bitstream(packed, nbits),
                                len(vals))
        np.testing.assert_array_equal(got, vals)


def test_util_copies_behave_alike(tmp_path):
    import io as _io
    rargs, pargs = both("util.args")
    rlog, plog = both("util.log")
    rtmp, ptmp = both("util.tmpfiles")
    argv = ["mem=2G", "verbose=0", "bwtonly=1", "rate=0.5", "in.bin", "x"]
    outs = []
    for m in (rargs, pargs):
        ai = m.ArgInfo(argv, progname="tool")
        ap = m.ArgParser(["-k", "3", "--name=v", "rest"])
        outs.append((ai.restargs, ai.get_int("mem", 0), ai.get("verbose"),
                     ai.get_bool("bwtonly", False), ai.get_float("rate", 0),
                     ai.has("nope"), m.parse_size("64k"), m.parse_size("3M"),
                     ap.has("k"), ap.get_int("k", 0), ap.get("name")))
    assert outs[0] == outs[1]
    assert outs[1][:2] == (["in.bin", "x"], 2 << 30)
    lines = []
    for m in (rlog, plog):
        buf = _io.StringIO()
        log = m.VerboseLog(1, stream=buf)
        log.v("shown")
        log.v("hidden", level=2)
        log.w("warned")
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and "shown" in lines[1] \
        and "hidden" not in lines[1]
    names = []
    for m, tag in ((rtmp, "r"), (ptmp, "p")):
        gen = m.TempFileNameGenerator(str(tmp_path / ("t" + tag)))
        a, b = gen.get("x"), gen.get("x")
        assert a != b
        open(a, "w").close()
        gen.cleanup()
        assert not os.path.exists(a)
        names.append([os.path.basename(n)[2:] for n in (a, b)])
    assert names[0] == names[1]


def test_bam_writer_byte_identical(tmp_path):
    rbam, pbam = both("io.bam")
    data = bytes(range(256)) * 300
    blobs = []
    for m, name in ((rbam, "r"), (pbam, "p")):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            w = m.BGZFWriter(f)
            w.write(data)
            w.close()
        blobs.append(_bytes(path))
    assert blobs[0] == blobs[1]
    assert pbam.bgzf_decompress(blobs[0]) == data == rbam.bgzf_decompress(
        blobs[1])
    assert [pbam.reg2bin(a, b) for a, b in ((0, 1), (5000, 90000))] == \
        [rbam.reg2bin(a, b) for a, b in ((0, 1), (5000, 90000))]


@pytest.mark.parametrize("seed", [0, 1])
def test_native_entry_points_equal(seed, ref_native):
    ref, port = both("native")
    assert port.get_lib() is not None, port._error
    rng = np.random.default_rng(seed)
    # periodic text with a few mutations: long common prefixes, ties
    text = np.tile(rng.integers(0, 3, 50), 40).astype(np.uint8)
    text[rng.integers(0, len(text), 5)] = 3
    n = len(text)
    xs = rng.integers(0, n, 400).astype(np.int64)
    for e in (0, 777, n - 1):
        np.testing.assert_array_equal(port.cmp_rot(text, n, e, xs),
                                      ref.cmp_rot(text, n, e, xs))
    big = rng.integers(0, 256, 100003).astype(np.uint8)
    np.testing.assert_array_equal(port.byte_hist(big), ref.byte_hist(big))
    np.testing.assert_array_equal(port.byte_hist(big),
                                  np.bincount(big, minlength=256))
    np.testing.assert_array_equal(port.hist_u8(big[:0], minlength=300),
                                  np.zeros(300, np.int64))
    data = np.repeat(big[:3000], 3).tobytes()
    blob = port.lz4_compress(data)
    assert blob == ref.lz4_compress(data)
    assert port.lz4_decompress(blob, len(data)) == data
    payload = big[:1000]
    np.testing.assert_array_equal(port.unpack_pac(payload, 3999, 1),
                                  ref.unpack_pac(payload, 3999, 1))


@pytest.mark.parametrize("kind", ["random", "periodic", "bytes"])
def test_native_kasai_plcp_equal(kind, ref_native):
    """The PLCP oracle of lcpbit's checks, ``native.kasai_plcp``, gives the
    reference's values: random DNA, a periodic text (l reaches n at every
    rank but 0) and a byte text."""
    ref, port = both("native")
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        text = rng.integers(0, 4, 5000)
    elif kind == "periodic":
        text = np.tile(rng.integers(0, 3, 7), 300)
    else:
        text = rng.integers(0, 256, 3000)
    text = text.astype(np.int32)
    sa = np.array(sorted(range(len(text)), key=lambda i: (
        np.roll(text, -i).tobytes(), i)), np.int64)
    got = port.kasai_plcp(text, sa)
    np.testing.assert_array_equal(got, ref.kasai_plcp(text, sa))
    assert got.dtype == np.int64
    if kind == "periodic":
        assert int(got.max()) == len(text)


def test_reference_library_lost_to_the_build_race_is_rebuilt(tmp_path):
    """A worker whose reference ``get_lib()`` already returned None (it
    lost the build race: ``_tried`` set, no library) still gets one from
    what the ``ref_native`` fixture does, and the byte comparisons
    hold."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the reference's native library cannot be "
                    "built here")
    ref = importlib.import_module("bwtb3m_tpu.native")
    saved = (ref._SO, ref._tried, ref._lib)
    ref._tried, ref._lib = True, None
    try:
        assert ref.get_lib() is None            # the lost race, replayed
        with _reference_library(
                lambda: (tmp_path / "lib").mkdir() or tmp_path / "lib") as mod:
            assert mod is ref and ref.get_lib() is not None
            assert ref._SO.startswith(str(tmp_path))
            assert os.listdir(tmp_path / "lib") == ["_bwtb3m_native.so"]
            test_native_entry_points_equal(0, mod)
            work = tmp_path / "work"
            work.mkdir()
            test_rl_codec_byte_identical_and_cross_loads(
                work, 4, 10000, True, 4096, mod)
            test_compact_pac_lz4_writers_byte_identical(work, mod)
        assert (ref._tried, ref._lib) == (True, None)
    finally:
        ref._SO, ref._tried, ref._lib = saved


def test_port_keeps_only_the_entry_points_it_calls():
    _ref, port = both("native")
    for later in ("gap_interleave", "gt0", "pack_bits_u8"):
        assert not hasattr(port, later), later
    assert callable(port.sais)
    assert os.path.dirname(port._SO) == os.path.join(
        REPO, "bwtb3m_tpu_torch", "build")


_RACE = r'''
import sys
sys.path.insert(0, sys.argv[1])
from bwtb3m_tpu_torch import native
native.BUILD_DIR = sys.argv[2]
native._SO = sys.argv[2] + "/_bwtb3m_native.so"
import numpy as np
lib = native.require_lib()
t = np.frombuffer(b"abracadabra", np.uint8)
out = native.cmp_rot(t, len(t), 0, np.arange(len(t)))
assert out is not None and out[0] == 0 and out[1] == 1, out
print("OK")
'''


def test_six_concurrent_first_uses_all_get_a_library(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    build = str(tmp_path / "build")          # fresh: nothing built yet
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, REPO, build],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "OK", err[-2000:]
    left = sorted(os.listdir(build))
    assert left == ["_bwtb3m_native.so"], left     # no temporary stays
