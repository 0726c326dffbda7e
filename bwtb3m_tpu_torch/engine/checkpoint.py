"""Durable merge-tree checkpointing.

Port of ``bwtb3m_tpu/engine/checkpoint.py`` (whose package cannot be
imported without JAX).  Each completed merge region of at least
``min_symbols`` symbols is saved under ``tmpprefix`` as an ``.npz`` file
(packed BWT, preisa samples, r_start, hist) by a background thread, and a
build resumes from the deepest complete tree nodes.  Writes are atomic
(tmp file + rename), files carry a build fingerprint so a stale directory
never leaks into another build, and saving a parent removes its
descendants' files.

The file format is the reference's, byte for byte: a file written by one
package loads in the other (pinned by tests/test_torch_checkpoint.py).
The packed BWT is the region's device bytes as they are (LSB-first
nibbles for ``bits=4``, an odd length padded with one 0 nibble), so a
save downloads them without repacking.
"""

from __future__ import annotations

import contextlib
import glob
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = "BWTREG1"


def build_key(text: np.ndarray, sigma: int, rate: int, block: int) -> str:
    """Build fingerprint: crc of the text's head + tail + length and the
    plan parameters that shape the tree."""
    t = np.ascontiguousarray(text[: 1 << 20], np.uint8)
    h = zlib.crc32(t.tobytes())
    h = zlib.crc32(
        np.ascontiguousarray(text[-(1 << 16):], np.uint8).tobytes(), h)
    return "%08x-%d-%d-%d-%d" % (h & 0xFFFFFFFF, len(text), sigma, rate,
                                 block)


def hash_span(key: str, s: int, e: int) -> int:
    return zlib.crc32(("%s:%d:%d" % (key, s, e)).encode()) & 0xFFFFFFFF


def region_path(prefix: str, key: str, s: int, e: int) -> str:
    return "%s_%s_reg_%d_%d.npz" % (prefix, MAGIC, hash_span(key, s, e), s)


def pack_host(bwt: np.ndarray, bits: int) -> np.ndarray:
    """Host uint8 BWT -> the file's packed bytes."""
    b = np.asarray(bwt, np.uint8)
    if bits == 8:
        return b
    if len(b) % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return b[0::2] | (b[1::2] << 4)


def unpack_host(packed: np.ndarray, n: int, bits: int) -> np.ndarray:
    if bits == 8:
        return packed[:n]
    out = np.empty(len(packed) * 2, np.uint8)
    out[0::2] = packed & 0x0F
    out[1::2] = packed >> 4
    return out[:n]


def save_region_file(path: str, key: str, s: int, e: int, bits: int,
                     packed: np.ndarray, samp_pos: np.ndarray,
                     samp_rank: np.ndarray, r_start: int,
                     hist: np.ndarray) -> None:
    """Write one region; ``packed`` is its BWT in the file's byte order
    (``pack_host``, or the region's device bytes)."""
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        np.savez(f, key=np.frombuffer(key.encode(), np.uint8),
                 s=np.int64(s), e=np.int64(e), bits=np.int64(bits),
                 packed=np.asarray(packed, np.uint8),
                 samp_pos=np.asarray(samp_pos, np.int64),
                 samp_rank=np.asarray(samp_rank, np.int64),
                 r_start=np.int64(r_start),
                 hist=np.asarray(hist, np.int64))
    os.replace(tmp, path)


def load_region_file(path: str, key: str
                     ) -> Optional[Tuple[int, int, np.ndarray, np.ndarray,
                                         np.ndarray, int, np.ndarray]]:
    """(s, e, bwt, samp_pos, samp_rank, r_start, hist), or None if the
    file is unreadable or from a different build."""
    try:
        with np.load(path) as z:
            if bytes(z["key"]).decode() != key:
                return None
            s, e, bits = int(z["s"]), int(z["e"]), int(z["bits"])
            bwt = unpack_host(z["packed"], e - s, bits)
            return (s, e, bwt, z["samp_pos"], z["samp_rank"],
                    int(z["r_start"]), z["hist"])
    except Exception:
        return None


class MergeCheckpointer:
    """Per-build checkpoint manager: background saves, resume scan,
    descendant cleanup.  ``min_symbols`` gates small regions."""

    def __init__(self, prefix: str, key: str, bits: int,
                 min_symbols: int = 1 << 26, sync: bool = False,
                 log=None, phase=None):
        self.prefix = prefix
        self.key = key
        self.bits = bits
        self.min_symbols = min_symbols
        self.log = log
        self.phase = phase
        self._sync = sync or bool(os.environ.get("BWTB3M_CKPT_SYNC"))
        self._pool = None
        self._pending: List = []
        self._saved: Dict[Tuple[int, int], str] = {}
        self._offered = set()

    def scan(self) -> Dict[Tuple[int, int], str]:
        """Saved regions of THIS build: (s, e) -> path."""
        avail = {}
        for path in glob.glob("%s_%s_reg_*.npz" % (self.prefix, MAGIC)):
            try:
                with np.load(path) as z:
                    if bytes(z["key"]).decode() != self.key:
                        continue
                    avail[(int(z["s"]), int(z["e"]))] = path
            except Exception:
                continue
        return avail

    def _do_save(self, s, e, bits, packed_get, samp_pos, samp_rank, r_start,
                 hist):
        path = region_path(self.prefix, self.key, s, e)
        timed = (self.phase("checkpoint write") if self.phase
                 else contextlib.nullcontext())
        try:
            with timed:
                save_region_file(path, self.key, s, e, bits, packed_get(),
                                 samp_pos, samp_rank, r_start, hist)
        except Exception as exc:       # checkpointing must never kill a build
            if self.log:
                self.log.v("checkpoint save failed for [%d,%d): %r"
                           % (s, e, exc))
            return
        self._saved[(s, e)] = path
        if self.log:
            self.log.v("checkpointed region [%d,%d) -> %s" % (s, e, path))
        self._cleanup_descendants(s, e)

    def _cleanup_descendants(self, s: int, e: int) -> None:
        for (cs, ce), path in list(self._saved.items()):
            if (cs, ce) != (s, e) and cs >= s and ce <= e:
                try:
                    os.remove(path)
                except OSError:
                    pass
                del self._saved[(cs, ce)]

    def offer(self, region, packed_get, force: bool = False) -> None:
        """Queue a completed region for saving.  ``packed_get`` returns
        its packed BWT bytes on the host; for a region on the device it
        downloads them inside the worker thread.

        ``force`` bypasses the backlog cap (the engine forces the root
        merge's children; a skipped offer stays re-offerable)."""
        s, e = region.s, region.e
        if (e - s < self.min_symbols or (s, e) in self._saved
                or (s, e) in self._offered):
            return
        # backlog cap by pending bytes: each queued save holds its
        # region's device bytes until the worker has downloaded them
        self._pending = [(f, b) for f, b in self._pending if not f.done()]
        region_bytes = (e - s) * self.bits // 8
        pending_bytes = sum(b for _f, b in self._pending)
        budget = int(os.environ.get("BWTB3M_CKPT_PENDING_BYTES",
                                    768 * 10 ** 6))
        if not force and self._pending and \
                pending_bytes + region_bytes > budget:
            if self.log:
                self.log.w("checkpoint backlog (%d B pending > %d B "
                           "budget): skipping save of [%d,%d)"
                           % (pending_bytes, budget, s, e))
            return
        self._offered.add((s, e))
        args = (s, e, self.bits, packed_get, region.samp_pos.copy(),
                region.samp_rank.copy(), region.r_start,
                region.hist.copy())
        if self._sync:
            self._do_save(*args)
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending.append(
            (self._pool.submit(self._do_save, *args), region_bytes))

    def adopt(self, spans) -> None:
        """Record files loaded at resume so later parent saves remove
        them too."""
        for span, path in spans.items():
            self._saved[span] = path

    def drain(self) -> None:
        for f, _b in self._pending:
            f.result()
        self._pending = []

    def finish(self, success: bool) -> None:
        """Join pending saves; on success remove every region file."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if success:
            for path in self._saved.values():
                try:
                    os.remove(path)
                except OSError:
                    pass
            self._saved.clear()
