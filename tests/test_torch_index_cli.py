"""The index tools and applications of the port against the reference's.

The cases of tests/test_cli.py that build or read an FM index
(``test_bwa_pipeline``, ``test_converters``,
``test_bwtdecodeblock_and_decoder``, the four ``probescan`` tests and the
two ``allhamdna`` tests), each tool run through both dispatchers,
``bwtb3m_tpu.cli`` and ``bwtb3m_tpu_torch.cli`` (the port with
``device=cpu`` where it takes one), on the same build: the same exit
codes and the same bytes, stdout and every file written (``.hwt``,
``.rlhwt``, ``.dnarank``, the BWA ``.bwt`` / ``.sa``, SAM and BAM).  The
builds are the port's (``bwtb3m device=cpu``), whose files equal the
reference's (tests/test_torch_pipeline.py).
"""

import gzip
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.io import compact
from bwtb3m_tpu_torch.io.pac import write_pac
from oracle import random_string

DEVICE_TOOLS = ("bwtdecodeblock", "probeScanDna", "allHamDna")


def _write_fasta(path, seqs):
    with open(path, "wb") as f:
        f.write("".join(">%s\n%s\n" % s for s in seqs).encode())


def _both(capsysbinary, args, outputs=()):
    """Run one tool with both packages; returns (port stdout, reference
    stdout) after asserting equal exit codes and equal bytes of every
    file in ``outputs`` (each package writes its own copy: the port's
    ``<path>``, the reference's ``<path>.ref``)."""
    port_args = list(args) + (["device=cpu"] if args[0] in DEVICE_TOOLS
                              else [])
    rc = dispatch([a.replace("@", "") for a in port_args])
    out = capsysbinary.readouterr().out
    rc_ref = jax_dispatch([a.replace("@", ".ref@").replace("@", "")
                           if "@" in a else a for a in args])
    out_ref = capsysbinary.readouterr().out
    assert rc == rc_ref
    for path in outputs:
        assert open(path, "rb").read() == open(path + ".ref", "rb").read(), \
            path
    return out, out_ref


def _build(tmp_path, name, codes, itype, *extra):
    pacp = str(tmp_path / name)
    write_pac(pacp, codes)
    assert dispatch(["bwtb3m", "inputtype=" + itype, "verbose=0",
                     "device=cpu", *extra, pacp]) == 0
    return pacp


def test_bwa_pipeline(tmp_path, capsysbinary):
    codes = random_string(500, 4, seed=11)
    pacp = _build(tmp_path, "g.pac", codes, "pacterm", "sasamplingrate=32",
                  "isasamplingrate=32")
    out_bwt = str(tmp_path / "bwa.bwt")
    out_sa = str(tmp_path / "bwa.sa")
    _both(capsysbinary, ["bwtb3mtobwa", pacp + ".bwt", out_bwt + "@",
                         out_sa + "@", "verbose=0"], (out_bwt, out_sa))
    from bwtb3m_tpu.index.bwa import read_bwa_bwt as jax_read_bwt
    from bwtb3m_tpu_torch.index.bwa import read_bwa_bwt, read_bwa_sa
    primary, L2, bases = read_bwa_bwt(out_bwt)
    assert len(bases) == 500
    ref = jax_read_bwt(out_bwt)
    assert primary == ref[0]
    np.testing.assert_array_equal(L2, ref[1])
    np.testing.assert_array_equal(bases, ref[2])
    assert read_bwa_sa(out_sa)[2] == 32


def test_converters(tmp_path, capsysbinary):
    codes = random_string(400, 4, seed=2)
    pacp = _build(tmp_path, "c.pac", codes, "pac")
    bwt = pacp + ".bwt"
    outs = {t: str(tmp_path / ("o." + t)) for t in
            ("hwt", "rlhwt", "dnarank", "dr256")}
    _both(capsysbinary, ["bwttohwt", "outputfilename=%s@" % outs["hwt"],
                         bwt], (outs["hwt"],))
    _both(capsysbinary, ["hwtToRlHwt", "verify=1",
                         "outputfilename=%s@" % outs["rlhwt"], bwt],
          (outs["rlhwt"],))
    _both(capsysbinary, ["bwttodnarank",
                         "outputfilename=%s@" % outs["dnarank"], bwt],
          (outs["dnarank"],))
    _both(capsysbinary, ["bwttodnarank256",
                         "outputfilename=%s@" % outs["dr256"], bwt],
          (outs["dr256"],))
    # the build's own .hwt equals the converter's, and decodes to the bwt
    assert open(pacp + ".hwt", "rb").read() == open(outs["hwt"], "rb").read()
    from bwtb3m_tpu_torch.index.dnarank import DNARank
    from bwtb3m_tpu_torch.index.wavelet import HuffmanWaveletTree
    from bwtb3m_tpu_torch.io.rl import rl_decode
    bwtarr = rl_decode(bwt)
    np.testing.assert_array_equal(
        HuffmanWaveletTree.read(outs["hwt"]).decode_all(), bwtarr)
    dr = DNARank.read(outs["dnarank"])
    assert dr.rank(2, 100) == int(np.count_nonzero(bwtarr[:100] == 2))
    # an up-to-date output is kept (the reference's freshness skip)
    assert dispatch(["bwttohwt", bwt]) == 0


def test_bwtdecodeblock_and_decoder(tmp_path, capsysbinary):
    data = b"the quick brown fox jumps over the lazy dog " * 20
    inp = tmp_path / "q.bin"
    inp.write_bytes(data)
    assert dispatch(["bwtb3m", "isasamplingrate=64", "sasamplingrate=8",
                     "verbose=0", "device=cpu", str(inp)]) == 0
    bwt = str(inp) + ".bwt"
    for low, length in (("100", "40"), ("870", "30"), ("0", "880"),
                        ("3", "1")):
        out, ref = _both(capsysbinary, ["bwtdecodeblock", "ref=" + str(inp),
                                        bwt, low, length])
        assert out == ref
        lo = int(low)
        assert out == (data * 2)[lo:lo + int(length)]
    out, ref = _both(capsysbinary, ["bwtb3mdecoderl", bwt])
    assert out == ref and len(out) == len(data)


def test_probescan_cli(tmp_path, capsysbinary):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 800, dtype=np.int32)
    pacp = _build(tmp_path, "r.pac", codes, "pacterm")
    probe = "".join("ACGT"[c] for c in codes[100:120])
    fa = str(tmp_path / "p.fa")
    _write_fasta(fa, [("p1", probe), ("p2", probe[::-1] + "N" + probe)])
    for mode in ("hwt", "rlhwt"):
        out, ref = _both(capsysbinary, ["probeScanDna", "mode=" + mode,
                                        "k=20", pacp + ".bwt", fa])
        assert out == ref
        name, nk, matched, _mean = out.decode().splitlines()[0].split("\t")
        assert name == "p1" and int(nk) == 1 and int(matched) == 1


def test_probescan_occ_mode(tmp_path, capsysbinary):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 1000, dtype=np.int32)
    pacp = _build(tmp_path, "o.pac", codes, "pacterm")
    probes = [("e1", "".join("ACGT"[c] for c in codes[200:220])),
              ("e2", "".join("ACGT"[(c + 1) % 4] for c in codes[200:230])),
              ("e3", "ACGTN" * 3)]
    fa = str(tmp_path / "probes.fa")
    _write_fasta(fa, probes)
    out, ref = _both(capsysbinary, ["probeScanDna", "mode=occ", "k=20",
                                    pacp + ".bwt", fa])
    assert out == ref
    out_hwt, _ref = _both(capsysbinary, ["probeScanDna", "mode=hwt", "k=20",
                                         pacp + ".bwt", fa])
    assert out.splitlines()[:2] == out_hwt.splitlines()[:2]
    assert out.decode().splitlines()[0].split("\t")[2] == "1"


def test_probescan_words_mode(tmp_path, capsysbinary):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 600, dtype=np.int32)
    ref_path = str(tmp_path / "w.compact")
    compact.write_compact(ref_path, codes, 2)
    probe = "".join("ACGT"[c] for c in codes[100:115])
    fa = str(tmp_path / "wp.fa")
    _write_fasta(fa, [("w1", probe), ("w2", probe * 2)])
    out, ref = _both(capsysbinary, ["probeScanDna", "mode=words", "k=15",
                                    ref_path, fa])
    assert out == ref
    _n, nk, matched, _m = out.decode().splitlines()[0].split("\t")
    assert int(nk) == 1 and int(matched) == 1


def test_probescan_words_long_kmer(tmp_path, capsysbinary):
    rng = np.random.default_rng(14)
    codes = rng.integers(0, 4, 2000, dtype=np.int32)
    ref_path = str(tmp_path / "lk.compact")
    compact.write_compact(ref_path, codes, 2)
    probe = "".join("ACGT"[c] for c in codes[500:545])  # k=45 > 31
    fa = str(tmp_path / "lk.fa")
    _write_fasta(fa, [("lk1", probe)])
    out, ref = _both(capsysbinary, ["probeScanDna", "mode=words", "k=45",
                                    ref_path, fa])
    assert out == ref
    _n, nk, matched, _m = out.decode().splitlines()[0].split("\t")
    assert int(nk) == 1 and int(matched) == 1


def test_allhamdna_cli(tmp_path, capsysbinary):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 600, dtype=np.int32)
    pacp = _build(tmp_path, "h.pac", codes, "pacterm", "sasamplingrate=8",
                  "isasamplingrate=8")
    read = list("ACGT"[c] for c in codes[50:80])
    read[10] = "ACGT"[(codes[60] + 1) % 4]  # one mismatch
    rc = "".join("TGCA"["ACGT".index(b)] for b in reversed(read))
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, [("r1", "".join(read)), ("r2", rc),
                      ("r3", "".join("ACGT"[c] for c in codes[590:600])
                       + "".join("ACGT"[c] for c in codes[:10]))])
    for maxmis in ("1", "2"):
        out, ref = _both(capsysbinary, ["allHamDna", "maxmis=" + maxmis,
                                        pacp + ".bwt", fa])
        assert out == ref
        lines = [l for l in out.decode().splitlines() if l.startswith("r1")]
        assert [l for l in lines if "\t51\t" in l and "NM:i:1" in l], out
    bam = str(tmp_path / "h.bam")
    _both(capsysbinary, ["allHamDna", "maxmis=1", "obam=%s@" % bam,
                         pacp + ".bwt", fa], (bam,))
    with gzip.open(bam, "rb") as f:
        assert f.read(4) == b"BAM\x01"


def test_allhamdna_unmapped_and_n_reads(tmp_path, capsysbinary):
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 400, dtype=np.int32)
    pacp = _build(tmp_path, "u.pac", codes, "pacterm", "sasamplingrate=8",
                  "isasamplingrate=8")
    fq = str(tmp_path / "ur.fq")
    with open(fq, "w") as f:
        for name, seq in (("miss", "A" * 25), ("withn", "ACGTN" * 5),
                          ("hit", "".join("ACGT"[c] for c in codes[7:40]))):
            f.write("@%s\n%s\n+\n%s\n" % (name, seq, "I" * len(seq)))
    out, ref = _both(capsysbinary, ["allHamDna", "maxmis=0", pacp + ".bwt",
                                    fq])
    assert out == ref
    names = [l.split("\t")[0] for l in out.decode().splitlines()
             if not l.startswith("@")]
    assert "withn" not in names and "hit" in names and "miss" in names
    assert os.path.getsize(pacp + ".bwt") > 0
