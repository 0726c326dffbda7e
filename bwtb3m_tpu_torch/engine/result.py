"""Construction result manifest and the rank-row loader.

Port of ``bwtb3m_tpu/engine/result.py``: ``BwtResult`` reads the JSON
``.meta`` manifest, and ``load_focc`` builds the fused rank rows of the
``.bwt`` on a device for the checkbwt and bwtcomputessa walks.  The
merge engine's device-rows hand-off and the legacy ``load_occ`` are not
ported yet (ROADMAP.md Queue 1 items 4 and 8).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..io import formats
from ..io.rl import open_bwt, rl_encode

# one-entry memo of built rank rows, shared across BwtResult instances:
# checkbwt and bwtcomputessa in one process build the rows once
_FOCC_CACHE: dict = {}


def write_bwt(path: str, bwt: np.ndarray, sigma: int) -> None:
    """Write ``bwt`` as a run-length ``.bwt`` file, the format that
    ``BwtResult.load_bwt`` reads."""
    rl_encode(path, bwt, sigma=sigma)


class BwtResult:
    def __init__(self, meta: dict):
        self.meta = meta

    @classmethod
    def load(cls, bwt_path: str) -> "BwtResult":
        base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
        return cls(formats.read_meta(base + ".meta"))

    # ---- file accessors -------------------------------------------------
    @property
    def bwt_path(self) -> str:
        return self.meta["files"]["bwt"]

    @property
    def hist_path(self) -> str:
        return self.meta["files"]["hist"]

    @property
    def preisa_path(self) -> str:
        return self.meta["files"]["preisa"]

    @property
    def sa_path(self) -> Optional[str]:
        return self.meta["files"].get("sa")

    @property
    def isa_path(self) -> Optional[str]:
        return self.meta["files"].get("isa")

    @property
    def n(self) -> int:
        return self.meta["n"]

    @property
    def sigma(self) -> int:
        return self.meta["sigma"]

    # ---- loading --------------------------------------------------------
    def load_bwt(self) -> np.ndarray:
        with open_bwt(self.bwt_path) as r:
            return r.decode_all()

    def load_preisa(self):
        return formats.read_preisa(self.preisa_path)

    def load_focc(self, device, dense: bool = True, log=None,
                  layout: str = "auto"):
        """Fused rank rows of the ``.bwt`` on ``device``: (focc, symbol_map
        or None).  With ``dense``, a sparse alphabet is densified and
        ``symbol_map[dense_id]`` is the file's symbol.  ``layout`` is
        ``ops/focc_build.py``'s: ``"auto"`` gives sector rows for a dense
        alphabet of at most 4 symbols (DNA).

        Memoized on (path, mtime, size, dense, device, layout): one
        process running checkbwt and bwtcomputessa builds the rows once."""
        device = torch.device(device)
        st = os.stat(self.bwt_path)
        key = (os.path.abspath(self.bwt_path), st.st_mtime_ns, st.st_size,
               bool(dense), str(device), layout)
        hit = _FOCC_CACHE.get(key)
        if hit is not None:
            return hit
        out = self._build_focc(device, dense, log, layout)
        _FOCC_CACHE.clear()   # hold at most one (rows are 0.5-5 B/symbol)
        _FOCC_CACHE[key] = out
        return out

    def _build_focc(self, device, dense: bool, log, layout: str):
        from ..ops.focc_build import build_focc_host

        t0 = time.monotonic()
        with open_bwt(self.bwt_path) as r:
            bwt = r.decode_all_u8() if hasattr(r, "decode_all_u8") else None
        if bwt is None:
            bwt = self.load_bwt()
        t_decode = time.monotonic() - t0
        sigma = self.sigma
        symmap = None
        t0 = time.monotonic()
        if dense:
            present = np.unique(bwt)
            if len(present) and (len(present) < sigma
                                 or present[-1] >= len(present)):
                remap = np.zeros(max(sigma, int(present[-1]) + 1), np.uint8)
                remap[present] = np.arange(len(present), dtype=np.uint8)
                bwt = remap[bwt]
                sigma = len(present)
                symmap = present.astype(np.int64)
        t_dense = time.monotonic() - t0
        t0 = time.monotonic()
        focc = build_focc_host(bwt, sigma, device, layout)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if log is not None:
            log.v("rank rows: decode %.3fs (host), densify %.3fs (host), "
                  "build %.3fs (%s), sigma=%d, %s rows"
                  % (t_decode, t_dense, time.monotonic() - t0, device,
                     sigma, focc.LAYOUT))
        return focc, symmap
