"""The compact-file tools of the port against the reference's.

The cases of tests/test_cli.py that prepare inputs or write compact
arrays (``test_fagz_to_compact``, ``test_fagz_to_compact4_meta``,
``test_fagz_uterm``, ``test_digits_to_compact``, the ``arraytocompact``
round trip of ``test_ssa_tools``, ``test_fa4suffixarraytocompact``,
``test_fagz_bigband_layouts``, ``test_decodecompact_cli``,
``test_bytestream_to_lz4_cli``), each tool run through both dispatchers,
``bwtb3m_tpu.cli`` and ``bwtb3m_tpu_torch.cli``, on the same inputs:
gzipped and plain FASTA, lowercase, N runs at both ends and inside,
several input files, ``rc=0/1``, ``seed=``, ``term=0/1`` and stdin.  The
same exit codes, stdout and bytes of every file written, and the files
read back as the reference's tests expect.  ``test_every_tool_usage_line``
is mirrored whole over the 29 tools.
"""

import gzip
import io
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu_torch.cli import TOOLS, dispatch
from bwtb3m_tpu_torch.cli.prep import _map_seq, _revcomp, read_compact4_meta
from bwtb3m_tpu_torch.io import compact, formats
from bwtb3m_tpu_torch.io.fasta import iter_fasta


def _write_fasta(path, seqs, gz=False, width=0):
    """FASTA of (name, sequence) records, lines of ``width`` bases (one
    line if 0), gzipped if ``gz``."""
    out = []
    for name, seq in seqs:
        out.append(">%s\n" % name)
        step = width or max(1, len(seq))
        out.extend(seq[a:a + step] + "\n" for a in range(0, len(seq), step))
    data = "".join(out).encode()
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)
    return str(path)


def _both(capsysbinary, args, outputs=()):
    """Run one tool with both packages; asserts equal exit codes, equal
    stdout and equal bytes of every file in ``outputs`` (the port writes
    ``<path>``, the reference ``<path>.ref``: an argument holding ``@``
    names an output, ``@`` marks where ``.ref`` goes; an entry
    ``(path, ext)`` is a file the tool names after its output,
    ``<path><ext>`` against ``<path>.ref<ext>``).  Returns the exit code
    and the port's stdout."""
    rc = dispatch([a.replace("@", "") for a in args])
    out = capsysbinary.readouterr().out
    rc_ref = jax_dispatch([a.replace("@", ".ref") for a in args])
    out_ref = capsysbinary.readouterr().out
    assert rc == rc_ref
    assert out == out_ref
    for entry in outputs:
        path, ext = entry if isinstance(entry, tuple) else (entry, "")
        with open(path + ext, "rb") as a, \
                open(path + ".ref" + ext, "rb") as b:
            assert a.read() == b.read(), path + ext
    return rc, out


def _genome(rng, n, lower=False, n_runs=()):
    """A DNA string of ``n`` bases with N runs at (start, length)."""
    s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())
    for a, k in n_runs:
        s[a:a + k] = b"N" * k
    s = s.decode()
    return s.lower() if lower else s


def _records(seed):
    rng = np.random.default_rng(seed)
    return [("s1", _genome(rng, 301, n_runs=((0, 5), (150, 12)))),
            ("s2 lowercase", _genome(rng, 200, lower=True,
                                     n_runs=((195, 5),))),
            ("s3", "ACGTRYKMacgtn" * 7),
            ("s4", _genome(rng, 64))]


@pytest.fixture(params=["gz", "plain"])
def fastas(request, tmp_path):
    """Two FASTA files (wrapped at 60 and 17 bases) of mixed records."""
    gz = request.param == "gz"
    recs = _records(3)
    return [_write_fasta(tmp_path / ("a.fa" + (".gz" if gz else "")),
                         recs[:2], gz, 60),
            _write_fasta(tmp_path / ("b.fa" + (".gz" if gz else "")),
                         recs[2:], gz, 17)]


@pytest.mark.parametrize("rc", ["rc=1", "rc=0", None])
def test_fagz_to_compact(tmp_path, capsysbinary, fastas, rc):
    out = str(tmp_path / "x.compact")
    args = ["fagzToCompact", "verbose=0", "outputfilename=%s@" % out,
            *fastas]
    if rc:
        args.insert(1, rc)
    assert _both(capsysbinary, args, [out])[0] == 0
    sym, bits = compact.read_compact(out)
    want = []
    for path in fastas:
        for _name, seq in iter_fasta(path):
            codes = _map_seq(seq)
            want += [np.where(codes >= 0, codes + 1, 5), [0]]
            if rc != "rc=0":
                r = _revcomp(codes)
                want += [np.where((r >= 0) & (r <= 3), r + 1, 5), [0]]
    assert bits == 3 and sym.tolist() == np.concatenate(want).tolist()


def test_fagz_to_compact_reference_case(tmp_path, capsysbinary):
    fa = _write_fasta(tmp_path / "x.fa.gz", [("s1", "ACGTN"), ("s2", "GGCC")],
                      gz=True)
    out = str(tmp_path / "x.compact")
    _both(capsysbinary, ["fagzToCompact", "rc=1", "outputfilename=%s@" % out,
                         fa], [out])
    assert compact.read_compact(out)[0].tolist() == [
        1, 2, 3, 4, 5, 0, 5, 1, 2, 3, 4, 0, 3, 3, 2, 2, 0, 3, 3, 2, 2, 0]


@pytest.mark.parametrize("extra", [[], ["rc=1"], ["seed=7"],
                                   ["rc=1", "seed=1234"]])
def test_fagz_to_compact4_meta(tmp_path, capsysbinary, fastas, extra):
    out = str(tmp_path / "y.c4")
    _both(capsysbinary, ["fagzToCompact4", "verbose=0", *extra,
                         "outputfilename=%s@" % out, *fastas],
          [out, (out, ".meta")])
    meta = read_compact4_meta(out + ".meta")
    sym, bits = compact.read_compact(out)
    assert bits == 2 and len(sym) == sum(s for s, _ in meta)
    # s1: N runs at the start and inside; the rc record mirrors them
    assert meta[0] == (301, [(0, 5), (150, 162)])
    if "rc=1" in extra:
        assert meta[1] == (301, [(139, 151), (296, 301)])


def test_fagz_to_compact4_reference_case(tmp_path, capsysbinary):
    fa = _write_fasta(tmp_path / "y.fa", [("s1", "ACNNGT"), ("s2", "TTTT")])
    out = str(tmp_path / "y.c4")
    _both(capsysbinary, ["fagzToCompact4", "outputfilename=%s@" % out,
                         "seed=7", fa], [out, (out, ".meta")])
    sym, bits = compact.read_compact(out)
    assert bits == 2 and len(sym) == 10
    assert read_compact4_meta(out + ".meta") == [(6, [(2, 4)]), (4, [])]
    assert sym[:2].tolist() == [0, 1] and sym[4:6].tolist() == [2, 3]
    assert sym[6:].tolist() == [3, 3, 3, 3]


@pytest.mark.parametrize("nrec", [1, 3, 5])
def test_fagz_uterm(tmp_path, capsysbinary, nrec):
    recs = [(str(i), s) for i, s in enumerate(["AC", "GT", "AA", "NNc",
                                               "tgca"][:nrec])]
    fa = _write_fasta(tmp_path / "z.fa", recs)
    out = str(tmp_path / "z.cu")
    _both(capsysbinary, ["fagzToCompactUTerm", "outputfilename=%s@" % out,
                         "verbose=0", fa], [out])
    if nrec == 3:
        sym, bits = compact.read_compact(out)
        assert bits == 3
        assert sym.tolist() == [2, 3, 0, 0, 4, 5, 0, 1, 2, 2, 1, 0]


@pytest.mark.parametrize("term", ["term=1", "term=0", None])
def test_digits_to_compact(tmp_path, capsysbinary, term):
    p = tmp_path / "d.txt"
    p.write_text("3141592653\n58979 32384x6")
    out = str(tmp_path / "d.compact")
    args = ["digitsToCompact", "outputfilename=%s@" % out, str(p)]
    if term:
        args.insert(1, term)
    _both(capsysbinary, args, [out])
    sym, bits = compact.read_compact(out)
    digits = [int(c) for c in "31415926535897932384" + "6"]
    if term == "term=1":
        assert sym.tolist() == [d + 1 for d in digits] + [0]
    else:
        assert sym.tolist() == digits
    assert bits == 4


@pytest.mark.parametrize("values", [[0], [5, 3, 1 << 20, 7],
                                    list(range(0, 3000, 16))])
def test_array_to_compact(tmp_path, capsysbinary, values):
    sa = str(tmp_path / "s.sa")
    formats.write_sampled_array(sa, 16, np.array(values, np.int64))
    out = str(tmp_path / "s.compact")
    assert _both(capsysbinary, ["arraytocompact", "verbose=0",
                                "outputfilename=%s@" % out, sa],
                 [out])[0] == 0
    back, bits = compact.read_compact(out)
    assert back.tolist() == values
    assert bits == max(1, max(values).bit_length())


def test_array_to_compact_default_name(tmp_path, capsysbinary):
    """The tool's default output name, as test_ssa_tools runs it."""
    sa = str(tmp_path / "t.sa")
    formats.write_sampled_array(sa, 32, np.arange(0, 4000, 32))
    assert dispatch(["arraytocompact", "verbose=0", sa]) == 0
    port = open(sa + ".compact", "rb").read()
    assert jax_dispatch(["arraytocompact", "verbose=0", sa]) == 0
    assert open(sa + ".compact", "rb").read() == port


@pytest.mark.parametrize("values", [[0, 3, 5, 6, 9, 10], [9, 0, 4],
                                    [0]])
def test_fa4suffixarraytocompact(tmp_path, capsysbinary, values):
    fa = _write_fasta(tmp_path / "z.fa", [("s1", "ACGTAC"), ("s2", "GGTT")])
    c4 = str(tmp_path / "z.c4")
    _both(capsysbinary, ["fagzToCompact4", "outputfilename=%s@" % c4, fa],
          [c4, (c4, ".meta")])
    sa = str(tmp_path / "z.sa")
    formats.write_sampled_array(sa, 1, np.array(values, np.int64))
    out = str(tmp_path / "z.fa4c")
    _both(capsysbinary, ["fa4suffixarraytocompact", "outputfilename=%s@"
                         % out, sa, c4 + ".meta"], [out])
    coords, _bits = compact.read_compact(out)
    # lens [6, 4]: obits 3; position 10 is past the text: (2, 0)
    want = [(0, v) if v < 6 else (1, v - 6) if v < 10 else (2, 0)
            for v in values]
    assert coords.tolist() == [(s << 3) | o for s, o in want]


def test_fa4suffixarraytocompact_of_a_build(tmp_path, capsysbinary, fastas):
    """The genome pipeline on the CPU: fagzToCompact4, bwtb3m from the
    compact, bwtcomputessa, fa4suffixarraytocompact; the coordinates
    decode to the .sa's positions.  The build is named apart from the
    compact: by default it writes ``<input>.meta``, the compact's."""
    c4 = str(tmp_path / "g.c4")
    assert dispatch(["fagzToCompact4", "verbose=0", "outputfilename=" + c4,
                     *fastas]) == 0
    bwt = str(tmp_path / "g.bwt")
    assert dispatch(["bwtb3m", "inputtype=compactstream", "bwtonly=1",
                     "verbose=0", "device=cpu", "outputfilename=" + bwt,
                     c4]) == 0
    assert dispatch(["bwtcomputessa", "sasamplingrate=4", "verbose=0",
                     "device=cpu", bwt]) == 0
    out = str(tmp_path / "g.fa4c")
    _both(capsysbinary, ["fa4suffixarraytocompact", "verbose=0",
                         "outputfilename=%s@" % out, bwt[:-4] + ".sa",
                         c4 + ".meta"], [out])
    lens = np.array([s for s, _ in read_compact4_meta(c4 + ".meta")])
    coords, _bits = compact.read_compact(out)
    obits = max(1, int(lens.max() - 1).bit_length())
    starts = np.r_[0, np.cumsum(lens)]
    _rate, sa = formats.read_sampled_array(bwt[:-4] + ".sa")
    np.testing.assert_array_equal(
        starts[coords >> obits] + (coords & ((1 << obits) - 1)), sa)


@pytest.mark.parametrize("seed", [None, "seed=9"])
def test_fagz_bigband_layouts(tmp_path, capsysbinary, seed):
    fa = _write_fasta(tmp_path / "bb.fa", [("s1", "ACGT"), ("s2", "GGC"),
                                           ("s3", "aNNt")])
    outs = {}
    for tool, ext in (("fagzToCompact4BigBand", ".c4bb"),
                      ("fagzToCompact4BigBandBiDir", ".c4bd")):
        out = str(tmp_path / ("bb" + ext))
        args = [tool, "outputfilename=%s@" % out, fa]
        if seed:
            args.insert(1, seed)
        _both(capsysbinary, args, [out])
        outs[tool] = compact.read_compact(out)
    s1, s2 = _map_seq(b"ACGT"), _map_seq(b"GGC")
    sym, bits = outs["fagzToCompact4BigBand"]
    assert bits == 2 and len(sym) == 2 * 11
    fwd = sym[:11]
    assert fwd[:7].tolist() == np.concatenate([s1, s2]).tolist()
    assert sym[11:].tolist() == _revcomp(fwd).tolist()
    sym2, _ = outs["fagzToCompact4BigBandBiDir"]
    assert sym2[:8].tolist() == np.concatenate([s1, _revcomp(s1)]).tolist()


@pytest.mark.parametrize("bits,sym", [(4, [3, 1, 4, 1, 5, 9, 2, 6]),
                                      (3, [0, 7, 5, 1, 2]),
                                      (2, list(range(4)) * 9)])
def test_decodecompact_cli(tmp_path, capsysbinary, bits, sym):
    path = str(tmp_path / "d.compact")
    compact.write_compact(path, np.array(sym, np.int64), bits)
    _rc, out = _both(capsysbinary, ["decodecompact", path])
    assert list(out) == sym


def _lz4_data():
    rng = np.random.default_rng(3)
    return np.concatenate([np.zeros(70000, np.uint8),
                           rng.integers(0, 256, 70000, dtype=np.uint8),
                           np.tile(np.arange(256, dtype=np.uint8), 300)])


@pytest.mark.parametrize("block", [None, "blocksize=4096"])
def test_bytestream_to_lz4_cli(tmp_path, capsysbinary, block):
    from bwtb3m_tpu_torch.io.lz4io import read_lz4_stream
    src = str(tmp_path / "s.bin")
    data = _lz4_data()
    data.tofile(src)
    out = str(tmp_path / "s.lz4")
    args = ["bytestreamToLz4", "outputfilename=%s@" % out, src]
    if block:
        args.insert(1, block)
    assert _both(capsysbinary, args, [out])[0] == 0
    assert np.array_equal(np.frombuffer(read_lz4_stream(out), np.uint8), data)


def test_bytestream_to_lz4_stdin(tmp_path, capsysbinary, monkeypatch):
    """``-`` reads the bytes from stdin."""
    data = _lz4_data()[:100000].tobytes()
    out = str(tmp_path / "in.lz4")
    for path in (out, out + ".ref"):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
        run = dispatch if path == out else jax_dispatch
        assert run(["bytestreamToLz4", "outputfilename=" + path, "-"]) == 0
    assert open(out, "rb").read() == open(out + ".ref", "rb").read()


def test_every_tool_usage_line(capsys):
    """Arg-less invocation of every tool prints usage and exits 1 in both
    packages (the whole 29-tool surface)."""
    from bwtb3m_tpu.cli import TOOLS as JAX_TOOLS, load_all
    load_all()
    assert len(TOOLS) == 29 and sorted(TOOLS) == sorted(JAX_TOOLS)
    for name in sorted(TOOLS):
        if name == "lcpbit":
            continue  # bare `lcpbit` would print usage; `-test` runs long
        assert dispatch([name]) == 1, name
        assert "usage" in capsys.readouterr().err, name
        assert jax_dispatch([name]) == 1, name
        assert "usage" in capsys.readouterr().err, name
