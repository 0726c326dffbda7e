"""BGZF + BAM writer — the ``bambam::BamWriter`` role.

The reference's allHamDna emits BAM with NM/MD tags through libmaus2's
bambam layer (upstream src/allHamDna.cpp:26-27,198-253). This is a
self-contained implementation of the two public formats:

* BGZF (SAM spec 4.1): gzip members with the BC extra field carrying the
  compressed block size, terminated by the fixed 28-byte EOF block. Each
  member is a valid gzip stream, so standard gzip readers can decompress
  the concatenation.
* BAM (SAM spec 4.2): binary header + little-endian alignment records
  with 4-bit packed sequence, binary CIGAR, and typed auxiliary tags.

A minimal reader lives here too (used by the tests; no samtools/pysam in
the image).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Dict, List, Optional, Tuple

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# 4-bit base codes: =ACMGRSVTWYHKDBN
_SEQ_CODE = {ch: i for i, ch in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OPS = "MIDNSHP=X"


class BGZFWriter:
    """Blocked gzip writer (SAM spec section 4.1)."""

    MAX_BLOCK = 0xFF00  # uncompressed payload per block

    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[: self.MAX_BLOCK])
            del self._buf[: self.MAX_BLOCK]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(payload)) + co.flush()
        bsize = 18 + len(comp) + 8  # header + deflate data + crc + isize
        # gzip member header with FEXTRA: the 6-byte BC subfield carries
        # the total block size minus one (SAM spec section 4.1)
        header = struct.pack("<4BIBB", 0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF)
        header += struct.pack("<H", 6)
        header += struct.pack("<2sHH", b"BC", 2, bsize - 1)
        self._fh.write(header)
        self._fh.write(comp)
        self._fh.write(struct.pack("<II", zlib.crc32(bytes(payload)),
                                   len(payload) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.flush()


def reg2bin(beg: int, end: int) -> int:
    """SAM spec section 5.3 bin number for [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _pack_seq(seq: str) -> bytes:
    out = bytearray((len(seq) + 1) // 2)
    for i, ch in enumerate(seq):
        c = _SEQ_CODE.get(ch.upper(), 15)
        out[i // 2] |= c << (4 if i % 2 == 0 else 0)
    return bytes(out)


class BamWriter:
    """BAM emission with the surface allHamDna needs: ungapped records
    with NM:i / MD:Z tags plus unmapped records."""

    def __init__(self, fh: BinaryIO, references: List[Tuple[str, int]],
                 header_text: str = ""):
        self._gz = BGZFWriter(fh)
        self.refs = references
        buf = bytearray()
        text = header_text.encode()
        buf += b"BAM\x01"
        buf += struct.pack("<i", len(text))
        buf += text
        buf += struct.pack("<i", len(references))
        for name, length in references:
            nm = name.encode() + b"\x00"
            buf += struct.pack("<i", len(nm))
            buf += nm
            buf += struct.pack("<i", length)
        self._gz.write(bytes(buf))

    def write_record(self, name: str, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar: List[Tuple[int, str]], seq: str,
                     qual: Optional[bytes] = None,
                     tags: Optional[Dict[str, object]] = None) -> None:
        """pos is 0-based (-1 for unmapped); cigar = [(length, op), ...]."""
        rn = name.encode() + b"\x00"
        l_seq = len(seq)
        cig = b"".join(
            struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
            for ln, op in cigar)
        seq_b = _pack_seq(seq)
        qual_b = qual if qual is not None else b"\xFF" * l_seq
        aln_end = pos + sum(ln for ln, op in cigar if op in "MDN=X")
        bin_ = reg2bin(pos, max(aln_end, pos + 1)) if pos >= 0 else 4680
        tag_b = bytearray()
        for key, val in (tags or {}).items():
            tag_b += key.encode()
            if isinstance(val, int):
                tag_b += b"i" + struct.pack("<i", val)
            else:
                tag_b += b"Z" + str(val).encode() + b"\x00"
        body = struct.pack(
            "<iiBBHHHiiii", ref_id, pos, len(rn), mapq, bin_,
            len(cigar), flag, l_seq, -1, -1, 0)
        rec = body + rn + cig + seq_b + qual_b + bytes(tag_b)
        self._gz.write(struct.pack("<i", len(rec)) + rec)

    def close(self) -> None:
        self._gz.close()


# ------------------------------------------------------------------ reader

def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a BGZF byte string (concatenated gzip members)."""
    out = bytearray()
    d = zlib.decompressobj(47)
    rest = data
    while rest:
        out += d.decompress(rest)
        rest = d.unused_data
        d = zlib.decompressobj(47)
    return bytes(out)


def read_bam(path: str):
    """Minimal BAM parser: returns (header_text, references, records) with
    records as dicts — the test oracle for BamWriter."""
    raw = bgzf_decompress(open(path, "rb").read())
    assert raw[:4] == b"BAM\x01", "bad BAM magic"
    off = 4
    (l_text,) = struct.unpack_from("<i", raw, off)
    off += 4
    text = raw[off : off + l_text].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        off += 4
        name = raw[off : off + l_name - 1].decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        refs.append((name, l_ref))
    records = []
    while off < len(raw):
        (block_size,) = struct.unpack_from("<i", raw, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_rn, mapq, bin_, n_cig, flag, l_seq, _nr, _np,
         _tl) = struct.unpack_from("<iiBBHHHiiii", raw, off)
        p = off + 32
        name = raw[p : p + l_rn - 1].decode()
        p += l_rn
        cigar = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", raw, p)
            p += 4
            cigar.append((v >> 4, _CIGAR_OPS[v & 0xF]))
        seq = ""
        codes = "=ACMGRSVTWYHKDBN"
        for i in range(l_seq):
            b = raw[p + i // 2]
            seq += codes[(b >> 4) if i % 2 == 0 else (b & 0xF)]
        p += (l_seq + 1) // 2
        qual = raw[p : p + l_seq]
        p += l_seq
        tags = {}
        while p < end:
            key = raw[p : p + 2].decode()
            typ = chr(raw[p + 2])
            p += 3
            if typ == "i":
                (v,) = struct.unpack_from("<i", raw, p)
                p += 4
            elif typ == "Z":
                q = raw.index(b"\x00", p)
                v = raw[p:q].decode()
                p = q + 1
            else:
                raise ValueError("unsupported tag type %r" % typ)
            tags[key] = v
        records.append(dict(name=name, flag=flag, ref_id=ref_id, pos=pos,
                            mapq=mapq, cigar=cigar, seq=seq, qual=qual,
                            tags=tags))
        off = end
    return text, refs, records
