"""BWA ``.pac`` packed 2-bit DNA files.

The reference's ``pac``/``pacterm`` input types (upstream src/bwtb3m.cpp
``inputtype=`` option; README "Generating an index for BWA") read the output
of ``bwa fa2pac``. BWA's .pac layout (public format):

* bases packed 4 per byte, first base in the HIGH two bits
  (base i lives at bits ``(3 - (i & 3)) * 2`` of byte ``i >> 2``),
* if ``len % 4 == 0`` an extra zero byte is appended,
* the final byte holds ``len % 4``,

so ``len = (filesize - 2) * 4 + last_byte``.
"""

from __future__ import annotations

import numpy as np


def read_pac(path: str, shift: int = 0) -> np.ndarray:
    """Read a BWA .pac file; returns 2-bit codes + shift as uint8
    (A=0 C=1 G=2 T=3 before the shift)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if len(raw) < 2:
        raise ValueError("truncated .pac file: %s" % path)
    last = int(raw[-1])
    if last > 3:
        raise ValueError("invalid .pac trailer byte %d in %s" % (last, path))
    n = (len(raw) - 2) * 4 + last
    payload = raw[: (n + 3) // 4]
    from .. import native
    bases = native.unpack_pac(payload, n, shift)
    if bases is not None:
        return bases
    # numpy fallback: byte -> 4 bases, high bits first
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    bases = ((payload[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return (bases[:n] + np.uint8(shift)).astype(np.uint8)


def write_pac(path: str, codes: np.ndarray) -> None:
    """Write 2-bit codes to a BWA-compatible .pac file."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    pad = (-n) % 4
    padded = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    quads = padded.reshape(-1, 4)
    packed = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    with open(path, "wb") as f:
        f.write(packed.astype(np.uint8).tobytes())
        if n % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([n % 4]))
