"""hwtToLCP: the LCP array, the succinct PLCP and the RMQ tree files.

Port of ``bwtb3m_tpu/lcp/wavelet_lcp.py``.  The reference tool loads the
``.hwt`` and computes the LCP from the wavelet tree; here, as in the JAX
package, the LCP is the PLCP of ``lcp/plcp.py`` (the text read through
the ``.meta``) permuted to rank order, so no index module is needed.  It
writes the plain ``.ulcp``, the succinct ``.lcp`` and an RMQ ``.rmm``
tree; ``checklcp=1`` cross-checks them against the host oracle.

.ulcp format: magic "ULCP", u64 n, u64 values (rank order: ulcp[i] = LCP
between SA[i] and SA[i-1]; ulcp[0] = 0).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..util import serial
from ..util.log import VerboseLog
from .plcp import (PLCPBitDecoder, _text_from_bwt_meta, compute_plcp,
                   kasai_plcp, write_plcp_file)
from .rmm import RMMTree

ULCP_MAGIC = b"ULCP"


def write_ulcp(path: str, lcp: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(ULCP_MAGIC)
        serial.write_u64(f, len(lcp))
        serial.write_u64_array(f, np.asarray(lcp).astype("<u8"))


def read_ulcp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(4) != ULCP_MAGIC:
            raise ValueError("not a ULCP file: %s" % path)
        n = serial.read_u64(f)
        return serial.read_u64_array(f, n).astype(np.int64)


def compute_lcp_rank_order(text: np.ndarray, sigma: int, device="cuda",
                           log=None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (lcp in rank order, plcp in text order, sa)."""
    plcp, sa = compute_plcp(text, sigma, device=device, log=log)
    return plcp[sa], plcp, sa


def hwt_to_lcp_files(bwt_path: str, check: bool = False,
                     device="cuda") -> int:
    log = VerboseLog(1)
    text, sigma = _text_from_bwt_meta(bwt_path)
    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    lcp, plcp, sa = compute_lcp_rank_order(text, sigma, device, log)
    write_ulcp(base + ".ulcp", lcp)
    write_plcp_file(base + ".lcp", plcp)
    RMMTree(lcp).write(base + ".rmm")
    log.v("wrote %s.ulcp/.lcp/.rmm (n=%d, avg lcp %.2f, max lcp %d)"
          % (base, len(lcp), float(lcp.mean()) if len(lcp) else 0.0,
             int(lcp.max()) if len(lcp) else 0))
    if check:
        if not np.array_equal(plcp, kasai_plcp(text, sa)):
            log.e("checklcp FAILED: PLCP mismatch vs independent recompute")
            return 1
        dec = PLCPBitDecoder(base + ".lcp", n=len(text))
        if not np.array_equal(dec.all(), plcp):
            log.e("checklcp FAILED: succinct file does not decode to PLCP")
            return 1
        log.v("checklcp ok (all %d entries)" % len(lcp))
    return 0
