"""Full-text BWT verification — the ``checkbwt`` walk.

Port of the fused path of ``bwtb3m_tpu/engine/verify.py``: the text is
walked backwards from every ``.preisa`` seed at once, one lane per seed,
and every emitted BWT symbol is compared with the circular-reverse text
read.  The walk is one launch of the LF-walk kernel with its verify
visit (``ops/lf_walk.py::verify_walk``); the text is a flat uint8 array on the device (the
reference's phase-aligned text rows were a TPU gather workaround).

Ranks and positions are uint32 in the kernel's narrow form up to 2^32
symbols; from 2^32 (and under ``BWTB3M_FORCE_WIDE``) the rank rows are
the wide rows of ``ops/wideocc.py`` and the walk is the kernel's 64-bit
form (the reference's ``_verify_chunk_w``), exact to 2^35 symbols.

Alphabets past 256 symbols (the reference's ``_check_bwt_legacy``): the
rank rows are the wavelet rows of ``ops/wavelet_rows.py``, the text is
densified through the same symbol map and held on the device as uint16
ids up to 65,536 symbols and int32 ids past them (up to 2^21), and the
walk is the kernel's form ``bwt_lf_walk_wm``; texts of 2^31
symbols or more raise ``ValueError`` there, as the reference's int32
lanes stop there.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.lf_walk import verify_walk
from ..ops.wavelet_rows import as_symbols
from ..ops.wideocc import WideOcc
from ..util.devices import resolve_device
from ..util.log import VerboseLog
from .result import BwtResult
from .ssa import seed_segments


def check_bwt(result: BwtResult, text: np.ndarray, device="cuda",
              log: Optional[VerboseLog] = None) -> bool:
    """True iff ``result``'s .bwt + .preisa reproduce ``text`` exactly:
    every one of the n symbols the LF walk emits equals the
    circular-reverse text read (the reference prints gok=1)."""
    log = log or VerboseLog(0)
    device = resolve_device(device)
    text = np.asarray(text)
    n = len(text)
    sigma_t = int(text.max()) + 1 if n else 1
    if n != result.n:
        log.v("checkbwt: text has %d symbols, the BWT %d" % (n, result.n))
        return False
    if sigma_t > 256 or result.sigma > 256:
        return _check_bwt_wavelet(result, text, device, log)
    focc, symmap = result.load_focc(device, dense=True, log=log)
    t0 = time.monotonic()
    text_dev = torch.from_numpy(np.require(text, np.uint8, "CW")).to(device)
    if symmap is not None:
        table = torch.full((256,), -1, dtype=torch.int16, device=device)
        table[torch.from_numpy(symmap).to(device)] = torch.arange(
            len(symmap), dtype=torch.int16, device=device)
        dense = table[text_dev.long()]
        if bool((dense < 0).any()):
            return False      # a text symbol the BWT does not hold
        text_dev = dense.to(torch.uint8)
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = seed_segments(ranks, positions, n)
    _write_checkinfo(result, seg_len, positions, ranks)

    def lanes(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    bad = verify_walk(focc, text_dev, lanes(ranks), lanes(positions),
                      lanes(seg_len))
    total_bad = int(bad.sum())
    log.v("checkbwt: %d lanes, %d mismatches over n=%d, text + walk %.3fs "
          "(%s, %s rows)" % (len(positions), total_bad, n,
                             time.monotonic() - t0, device,
                             "wide" if isinstance(focc, WideOcc)
                             else "narrow"))
    return total_bad == 0


def _check_bwt_wavelet(result: BwtResult, text: np.ndarray, device,
                       log: VerboseLog) -> bool:
    """checkbwt past 256 symbols, the reference's ``_check_bwt_legacy``:
    the text densified through the rows' symbol map (a symbol the BWT
    does not hold fails before the ``.checkinfo`` is written, as there),
    on the device as ``wavelet_rows.symbol_dtype`` gives it (uint16 bits
    or int32), one launch of the wavelet walk."""
    n = len(text)
    if n >= 1 << 31:
        raise ValueError("checkbwt past 256 symbols takes n < 2^31, as the "
                         "reference's int32 lanes: n=%d" % n)
    wm, symmap = result.load_wavelet(device, dense=True, log=log)
    t0 = time.monotonic()
    t = torch.from_numpy(np.ascontiguousarray(text, np.int32)).to(device)
    if symmap is not None:
        sm = torch.from_numpy(symmap).to(device)
        table = torch.full((max(int(t.max()), int(sm.max())) + 1,), -1,
                           dtype=torch.int32, device=device)
        table[sm] = torch.arange(len(symmap), dtype=torch.int32,
                                 device=device)
        t = table[t.long()]
        if bool((t < 0).any()):
            return False      # a text symbol the BWT does not hold
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = seed_segments(ranks, positions, n)
    _write_checkinfo(result, seg_len, positions, ranks)
    if int(t.max()) >= wm.sigma:
        return False          # such a symbol is never emitted
    text_dev = as_symbols(t, wm.sigma)
    del t

    def lanes(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    bad = verify_walk(wm, text_dev, lanes(ranks), lanes(positions),
                      lanes(seg_len))
    total_bad = int(bad.sum())
    log.v("checkbwt: %d lanes, %d mismatches over n=%d, text + walk %.3fs "
          "(%s, wavelet rows of %d levels)"
          % (len(positions), total_bad, n, time.monotonic() - t0, device,
             wm.levels))
    return total_bad == 0


def _write_checkinfo(result, seg_len, positions, ranks):
    # the role of the reference's .preisa.checkinfo thread-split file:
    # triples (segment length, start pos, start rank) per lane
    try:
        info = np.empty((len(positions), 3), dtype="<u8")
        info[:, 0] = seg_len
        info[:, 1] = positions
        info[:, 2] = ranks
        with open(result.preisa_path + ".checkinfo", "wb") as f:
            f.write(info.tobytes())
    except OSError:
        pass  # read-only locations: the check itself proceeds
