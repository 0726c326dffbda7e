"""The cases of ``tests/test_bam.py``, the port's ``io/bam.py`` and
``allHamDna obam=`` against the reference's: BGZF bytes (gzip-valid,
the fixed EOF block, the BC subfields), BAM records read back, the
SAM binning scheme, and ``allHamDna``'s BAM holding its SAM's records,
each byte for byte the reference's."""

import gzip
import io
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.cli import dispatch as jax_dispatch
from bwtb3m_tpu.io import bam as jax_bam
from bwtb3m_tpu_torch.cli import dispatch
from bwtb3m_tpu_torch.io import bam
from bwtb3m_tpu_torch.io.pac import write_pac

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def test_bgzf_roundtrip_and_gzip_compat():
    payload = bytes(np.random.default_rng(0).integers(0, 256, 300000,
                                                      dtype=np.uint8))
    blobs = []
    for mod in (bam, jax_bam):
        buf = io.BytesIO()
        w = mod.BGZFWriter(buf)
        w.write(payload)
        w.close()
        blobs.append(buf.getvalue())
    data = blobs[0]
    assert data == blobs[1]
    assert bam.bgzf_decompress(data) == payload == gzip.decompress(data)
    assert data.endswith(EOF_BLOCK)
    off = 0
    while off < len(data):
        assert data[off:off + 4] == b"\x1f\x8b\x08\x04"
        (bsize,) = struct.unpack_from("<H", data, off + 16)
        off += bsize + 1
    assert off == len(data)


def test_bam_write_read_roundtrip(tmp_path):
    for mod, name in ((bam, "p.bam"), (jax_bam, "r.bam")):
        with open(tmp_path / name, "wb") as fh:
            w = mod.BamWriter(fh, [("ref", 1000)],
                              "@HD\tVN:1.6\n@SQ\tSN:ref\tLN:1000\n")
            w.write_record("r1", 0, 0, 41, 255, [(5, "M")], "ACGTA",
                           tags={"NM": 1, "MD": "3A1"})
            w.write_record("r2", 16, 0, 7, 255, [(4, "M")], "TTTT",
                           tags={"NM": 0, "MD": "4"})
            w.write_record("u1", 4, -1, -1, 0, [], "ACG")
            w.close()
    assert (tmp_path / "p.bam").read_bytes() == \
        (tmp_path / "r.bam").read_bytes()
    text, refs, recs = bam.read_bam(str(tmp_path / "p.bam"))
    assert (text, refs, recs) == jax_bam.read_bam(str(tmp_path / "p.bam"))
    assert refs == [("ref", 1000)] and "SN:ref" in text
    assert [r["name"] for r in recs] == ["r1", "r2", "u1"]
    assert recs[0]["pos"] == 41 and recs[0]["flag"] == 0
    assert recs[0]["cigar"] == [(5, "M")] and recs[0]["seq"] == "ACGTA"
    assert recs[0]["tags"] == {"NM": 1, "MD": "3A1"}
    assert recs[1]["flag"] == 16 and recs[1]["tags"]["MD"] == "4"
    assert recs[2]["flag"] == 4 and recs[2]["ref_id"] == -1


@pytest.mark.parametrize("beg,end,want", [
    (0, 1, 4681), (0, 1 << 14, 4681), (1 << 14, (1 << 14) + 1, 4682),
    (0, (1 << 14) + 1, 585)])
def test_reg2bin_spec_examples(beg, end, want):
    assert bam.reg2bin(beg, end) == jax_bam.reg2bin(beg, end) == want


def test_allhamdna_bam_matches_sam(tmp_path, capsys):
    codes = np.random.default_rng(4).integers(0, 4, 600, dtype=np.int32)
    bases = "ACGT"
    read = list(bases[c] for c in codes[50:80])
    read[10] = bases[(codes[60] + 1) % 4]
    runs = {}
    for name, run, extra in (("port", dispatch, ["device=cpu"]),
                             ("ref", jax_dispatch, [])):
        d = tmp_path / name
        d.mkdir()
        pacp = str(d / "h.pac")
        write_pac(pacp, codes)
        assert run(["bwtb3m", "inputtype=pacterm", "sasamplingrate=8",
                    "isasamplingrate=8", "verbose=0", *extra, pacp]) == 0
        fa = str(d / "reads.fa")
        with open(fa, "w") as f:
            f.write(">r1\n%s\n>zz\n%s\n" % ("".join(read), "A" * 25))
        capsys.readouterr()
        assert run(["allHamDna", "maxmis=1", *extra, pacp + ".bwt", fa]) == 0
        sam = [l for l in capsys.readouterr().out.splitlines()
               if l and not l.startswith("@")]
        bamp = str(d / "o.bam")
        assert run(["allHamDna", "maxmis=1", "obam=" + bamp, *extra,
                    pacp + ".bwt", fa]) == 0
        runs[name] = (sam, open(bamp, "rb").read())
    assert runs["port"] == runs["ref"]
    sam = runs["port"][0]
    _t, refs, recs = bam.read_bam(str(tmp_path / "port" / "o.bam"))
    assert refs[0][0] == "ref" and len(recs) == len(sam)
    for line, rec in zip(sam, recs):
        f = line.split("\t")
        assert rec["name"] == f[0] and rec["flag"] == int(f[1])
        if rec["flag"] != 4:
            assert rec["pos"] + 1 == int(f[3])
            assert "%dM" % rec["cigar"][0][0] == f[5] and rec["seq"] == f[9]
            nm = [x for x in f if x.startswith("NM:i:")][0]
            md = [x for x in f if x.startswith("MD:Z:")][0]
            assert rec["tags"]["NM"] == int(nm[5:])
            assert rec["tags"]["MD"] == md[5:]
