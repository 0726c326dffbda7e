"""Construction result manifest and the rank-row loader.

Port of ``bwtb3m_tpu/engine/result.py``: ``BwtResult`` reads the JSON
``.meta`` manifest, and ``load_focc`` builds the fused rank rows of the
``.bwt`` on a device for the checkbwt and bwtcomputessa walks: from the
file, or, on the ``BwtResult`` that a merge-engine build returned, from
the final region's packed symbols that are still on the device
(``bind_device_rows``), which skips the host decode and densify.  That
hand-off lives on the result object and nowhere else: it is taken by the
first ``load_focc`` it can serve and goes with the object, so a caller
that builds and never checks pins the symbols only while it keeps the
result.  Texts of 2^32 symbols or more, or any text under
``BWTB3M_FORCE_WIDE``, get the wide rank rows (``ops/wideocc.py``); the
memo key carries the variant, so narrow rows never serve a wide request
nor the other way round.  Alphabets past 256 symbols take the wavelet
rank rows of ``ops/wavelet_rows.py`` (``load_wavelet``, the port of the
reference's ``load_occ``), memoized in the same memo.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..io import formats
from ..io.rl import open_bwt, rl_encode
from ..util import trace

# one-entry memo of built rank rows, shared across BwtResult instances:
# checkbwt and bwtcomputessa in one process build the rows once
_FOCC_CACHE: dict = {}


def _file_key(bwt_path: str) -> tuple:
    st = os.stat(bwt_path)
    return (os.path.abspath(bwt_path), st.st_mtime_ns, st.st_size)


def wide_rows(n: int) -> bool:
    """Whether the walks of a text of ``n`` symbols take the wide rank
    rows: n >= 2^32, or ``BWTB3M_FORCE_WIDE`` set (the wide path on a
    small text, as the reference's tests drive it)."""
    return n >= 1 << 32 or bool(os.environ.get("BWTB3M_FORCE_WIDE"))


def clear_caches() -> None:
    """Drop the rank-row memo."""
    _FOCC_CACHE.clear()


def write_bwt(path: str, bwt: np.ndarray, sigma: int) -> None:
    """Write ``bwt`` as a run-length ``.bwt`` file, the format that
    ``BwtResult.load_bwt`` reads."""
    rl_encode(path, bwt, sigma=sigma)


class BwtResult:
    def __init__(self, meta: dict):
        self.meta = meta
        # (file key, DeviceRowsHandle, symmap or None) of a pending
        # device-rows hand-off, see bind_device_rows
        self._device_rows = None

    def bind_device_rows(self, handle, hist: np.ndarray,
                         symmap=None) -> None:
        """Bind a ``DeviceRowsHandle`` (``engine/merge_scaled.py``) to the
        ``.bwt`` this result names, which the build has just written: the
        file's path, mtime and size are kept, so only that very file can
        take the symbols.  The handle names the build its symbols came
        from (n, dense sigma, symbol histogram); binding raises
        ``ValueError`` unless all three match this result's n, sigma and
        ``hist`` (the file's symbol histogram), so the symbols of one
        build never serve another build's file.  ``symmap`` maps the
        handle's dense symbol ids to the file's symbols when the engine
        ran rank-compacted; the hit then mirrors what the file build with
        ``dense=True`` returns."""
        n, sigma = self.n, self.sigma
        h = np.asarray(handle.hist, np.int64)
        b = np.asarray(hist, np.int64)
        if symmap is None:
            if handle.n != n or handle.sigma != sigma:
                raise ValueError(
                    "device-rows handle identity mismatch: handle (n=%d, "
                    "sigma=%d) vs build (n=%d, sigma=%d)"
                    % (handle.n, handle.sigma, n, sigma))
            if len(h) != len(b) or not np.array_equal(h, b):
                raise ValueError("device-rows handle histogram mismatch")
        else:
            sm = np.asarray(symmap, np.int64)
            if handle.n != n or handle.sigma != len(sm):
                raise ValueError(
                    "device-rows handle identity mismatch under symmap: "
                    "handle (n=%d, sigma=%d) vs build (n=%d, |symmap|=%d)"
                    % (handle.n, handle.sigma, n, len(sm)))
            # the file's histogram restricted to the mapped symbols must
            # be the dense histogram, and carry all the mass
            if (sm.max(initial=-1) >= len(b)
                    or not np.array_equal(b[sm], h)
                    or int(b.sum()) != int(h.sum())):
                raise ValueError("device-rows handle histogram mismatch "
                                 "under symmap")
        self._device_rows = (
            _file_key(self.bwt_path), handle,
            None if symmap is None else np.asarray(symmap, np.int64).copy())

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
                  layout: str = "auto", wide: Optional[bool] = None):
        """Fused rank rows of the ``.bwt`` on ``device``: (focc, symbol_map
        or None).  With ``dense``, a sparse alphabet is densified and
        ``symbol_map[dense_id]`` is the file's symbol.  ``layout`` is
        ``ops/focc_build.py``'s: ``"auto"`` gives sector rows for a dense
        alphabet of at most 4 symbols (DNA).  ``wide``: the
        ``ops/wideocc.py::WideOcc`` over the rows; by default where
        ``wide_rows(n)`` says so (a caller that runs only narrow kernels
        asks for ``False``, below 2^32 symbols).

        Memoized on (path, mtime, size, dense, device, layout, wide): one
        process running checkbwt and bwtcomputessa builds the rows once.
        A device-rows hand-off bound to this result (``bind_device_rows``)
        serves a ``dense`` request on the device that holds it while the
        file is the one the build wrote (same path, mtime and size): the
        rows are built from the build's packed symbols, with no host
        decode or densify, and the hand-off is released."""
        device = torch.device(device)
        wide = wide_rows(self.n) if wide is None else bool(wide)
        if not wide and self.n >= 1 << 32:
            raise ValueError("a text of 2^32 symbols or more takes the wide "
                             "rank rows")
        fkey = _file_key(self.bwt_path)
        key = fkey + (bool(dense), str(device), layout, wide)
        hit = _FOCC_CACHE.get(key)
        if hit is not None:
            return hit
        out = self._focc_from_handoff(fkey, device, dense, log, layout, wide)
        if out is None:
            out = self._build_focc(device, dense, log, layout, wide)
        _FOCC_CACHE.clear()   # hold at most one (rows are 0.5-5 B/symbol)
        _FOCC_CACHE[key] = out
        return out

    def load_wavelet(self, device, dense: bool = True, log=None):
        """Wavelet rank rows of the ``.bwt`` on ``device`` (texts below
        2^31 symbols; ``ops/wavelet_rows.py``): (rows, symbol_map or
        None).  The port of the reference's ``load_occ``: with ``dense``
        a sparse alphabet is densified, ``symbol_map[dense_id]`` being
        the file's symbol, as there.  The decoded symbols go to the
        device as int32 and are densified there.  Memoized with
        ``load_focc``'s memo on (path, mtime, size, dense, device)."""
        from ..ops.wavelet_rows import build_wavelet

        device = torch.device(device)
        if self.n >= 1 << 31:
            raise ValueError("wavelet rank rows (sigma > 256) take n < 2^31, "
                             "as the reference's int32 lanes: n=%d" % self.n)
        fkey = _file_key(self.bwt_path)
        key = fkey + (bool(dense), str(device), "wavelet")
        hit = _FOCC_CACHE.get(key)
        if hit is not None:
            return hit
        with trace.span("index.rows.decode") as decode:
            bwt = self.load_bwt()
        with trace.span("index.rows.build") as build:
            sym = torch.from_numpy(np.ascontiguousarray(bwt, np.int32)).to(
                device)
            del bwt
            sigma, symmap = self.sigma, None
            if dense:
                hist = torch.bincount(sym, minlength=sigma)
                present = torch.nonzero(hist).squeeze(1)
                if len(present) and (len(present) < sigma
                                     or int(present[-1]) >= len(present)):
                    table = torch.zeros(len(hist), dtype=torch.int32,
                                        device=device)
                    table[present] = torch.arange(
                        len(present), dtype=torch.int32, device=device)
                    sym = table[sym.long()]
                    sigma = len(present)
                    symmap = present.cpu().numpy().astype(np.int64)
            wm = build_wavelet(sym, sigma)
            del sym
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if log is not None:
            log.v("rank rows: decode %.3fs (host), densify + build %.3fs "
                  "(%s), sigma=%d, wavelet rows of %d levels, %d bytes"
                  % (decode.seconds, build.seconds, device, sigma,
                     wm.levels, wm.nbytes()))
        _FOCC_CACHE.clear()
        _FOCC_CACHE[key] = (wm, symmap)
        return wm, symmap

    def _focc_from_handoff(self, fkey, device, dense: bool, log,
                           layout: str, wide: bool):
        """(focc, symmap) from a pending hand-off, or None.  Only a
        handle whose symbols are the file's dense symbols is registered
        (every symbol present), so no remap applies here; a rank-compacted
        build's handle is the dense structure and serves only ``dense``
        requests."""
        if self._device_rows is None:
            return None
        key, handle, symmap = self._device_rows
        if key != fkey:                  # rewritten since: never again
            self._device_rows = None
            return None
        have = handle.packed.device
        if (handle.n != self.n or have.type != device.type
                or device.index not in (None, have.index)
                or (symmap is None and handle.sigma != self.sigma)
                or (symmap is not None and not dense)):
            return None
        from ..ops.focc_build import build_focc_from_packed

        self._device_rows = None
        with trace.span("index.rows.build") as build:
            focc = build_focc_from_packed(handle.packed, handle.n,
                                          handle.sigma, handle.bits, layout,
                                          wide=wide)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if log is not None:
            log.v("rank rows: from the build's device symbols (hand-off), "
                  "build %.3fs (%s), sigma=%d, %s%s rows"
                  % (build.seconds, device, handle.sigma,
                     "wide " if wide else "", focc.LAYOUT))
        return focc, symmap

    def _build_focc(self, device, dense: bool, log, layout: str,
                    wide: bool):
        from ..ops.focc_build import build_focc_host

        with trace.span("index.rows.decode") as decode:
            with open_bwt(self.bwt_path) as r:
                bwt = (r.decode_all_u8() if hasattr(r, "decode_all_u8")
                       else None)
            if bwt is None:
                bwt = self.load_bwt()
        sigma = self.sigma
        symmap = None
        with trace.span("index.rows.densify") as densify:
            if dense:
                present = np.unique(bwt)
                if len(present) and (len(present) < sigma
                                     or present[-1] >= len(present)):
                    remap = np.zeros(max(sigma, int(present[-1]) + 1),
                                     np.uint8)
                    remap[present] = np.arange(len(present), dtype=np.uint8)
                    bwt = remap[bwt]
                    sigma = len(present)
                    symmap = present.astype(np.int64)
        with trace.span("index.rows.build") as build:
            focc = build_focc_host(bwt, sigma, device, layout, wide=wide)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if log is not None:
            log.v("rank rows: decode %.3fs (host), densify %.3fs (host), "
                  "build %.3fs (%s), sigma=%d, %s%s rows"
                  % (decode.seconds, densify.seconds, build.seconds, device,
                     sigma, "wide " if wide else "", focc.LAYOUT))
        return focc, symmap
