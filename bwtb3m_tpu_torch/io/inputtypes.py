"""Input types: the six text formats bwtb3m constructs BWTs over.

Reference: ``BwtMergeSortOptions::parseInputType`` dispatch and the per-type
reader classes ``ByteInputTypes / CompactInputTypes / PacInputTypes /
PacTermInputTypes / Lz4InputTypes / Utf8InputTypes``
(upstream src/checkbwt.cpp:260-270, upstream src/bwtb3m.cpp:43).

Each input type loads the text as an int32 symbol array plus its alphabet
size. The text is treated as *circular* everywhere (reference README
"Output": no terminator is appended; comparisons wrap), so readers also
provide circular slicing — the role of the reference's ``circular_wrapper`` /
``circular_reverse_wrapper`` (upstream src/checkbwt.cpp:168,183).
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np

from . import compact, pac
from .lz4io import read_lz4_stream

PACTERM_TERMINATOR = 0  # unique terminator, smallest symbol (BWA's '$')


class InputType:
    """Base: load(path) -> (symbols, sigma). Symbols are uint8 whenever
    sigma <= 256 (4x less host memory traffic than int32 staging), int32
    otherwise."""

    name = "?"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    @classmethod
    def load_bounded(cls, path: str, spill_path: str):
        """(symbols, sigma, spill_or_None) with bounded peak RSS: the
        symbols come back as a READ-ONLY uint8 memmap whose pages the
        kernel reclaims under pressure — the reference's streaming
        default (copyinputtomemory is opt-in,
        upstream src/bwtb3m.cpp:54).  Subclasses with packed
        formats decode chunk-by-chunk straight into the memmap so the
        load transient is O(chunk), not O(n); this base fallback loads
        fully once, then spills (types without a chunked decoder)."""
        symbols, sigma = cls.load(path)
        if sigma > 256:
            return symbols, sigma, None
        np.asarray(symbols, np.uint8).tofile(spill_path)
        del symbols
        return np.memmap(spill_path, np.uint8, mode="r"), sigma, spill_path


class ByteInput(InputType):
    name = "bytestream"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        return np.fromfile(path, dtype=np.uint8), 256

    @classmethod
    def load_bounded(cls, path: str, spill_path: str):
        # the file IS the symbol array: zero-copy read-only mapping
        return np.memmap(path, np.uint8, mode="r"), 256, None


class CompactInput(InputType):
    name = "compactstream"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        symbols, bits = compact.read_compact(path)
        return symbols, 1 << bits

    @classmethod
    def load_bounded(cls, path: str, spill_path: str):
        with open(path, "rb") as f:
            bits, n = compact.read_compact_header(f)
            out = np.memmap(spill_path, np.uint8, mode="w+",
                            shape=(max(1, n),))
            CHS = 1 << 26     # symbols per chunk, multiple of 8 so every
            base = 0          # chunk's payload is byte-aligned
            while base < n:
                cnt = min(CHS, n - base)
                nbytes = (cnt * bits + 7) // 8
                data = np.frombuffer(f.read(nbytes), np.uint8)
                out[base : base + cnt] = compact.unpack_bits(
                    data, bits, cnt).astype(np.uint8)
                base += cnt
        out.flush()
        del out
        return (np.memmap(spill_path, np.uint8, mode="r"), 1 << bits,
                spill_path)


def _pac_unpack_bounded(path: str, spill_path: str, shift: int,
                        terminator: bool):
    """Chunked .pac decode into a uint8 memmap: O(chunk) transient."""
    size = np.int64(os_path_size(path))
    with open(path, "rb") as f:
        f.seek(-1, 2)
        last = f.read(1)[0]
        if last > 3:
            raise ValueError("invalid .pac trailer byte %d in %s"
                             % (last, path))
        n = (int(size) - 2) * 4 + last
        total = n + (1 if terminator else 0)
        out = np.memmap(spill_path, np.uint8, mode="w+",
                        shape=(max(1, total),))
        f.seek(0)
        CH = 1 << 24                      # payload bytes -> 64 M bases
        base = 0
        from .. import native
        while base < n:
            take = min(CH, (n - base + 3) // 4)
            payload = np.frombuffer(f.read(take), np.uint8)
            cnt = min(4 * len(payload), n - base)
            bases = native.unpack_pac(payload, cnt, shift)
            if bases is None:
                shifts = np.array([6, 4, 2, 0], np.uint8)
                bases = (((payload[:, None] >> shifts[None, :]) & 3)
                         .reshape(-1)[:cnt] + np.uint8(shift)).astype(
                             np.uint8)
            out[base : base + cnt] = bases
            base += cnt
        if terminator:
            out[n] = PACTERM_TERMINATOR
    out.flush()
    del out
    return np.memmap(spill_path, np.uint8, mode="r"), spill_path


def os_path_size(path: str) -> int:
    import os
    return os.path.getsize(path)


class PacInput(InputType):
    name = "pac"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        return pac.read_pac(path), 4

    @classmethod
    def load_bounded(cls, path: str, spill_path: str):
        symbols, spill = _pac_unpack_bounded(path, spill_path, 0, False)
        return symbols, 4, spill


class PacTermInput(InputType):
    name = "pacterm"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        # pacterm: the pac text followed by one unique terminator symbol.
        # Bases are shifted to {1..4} and the terminator is 0, strictly
        # SMALLER than every base — exactly BWA's '$' ordering, so the
        # circular rotation sort coincides with BWA's suffix sort of T$
        # (the unique smallest symbol ends every comparison). This is what
        # makes the bwtb3mtobwa export (upstream src/bwtb3mtobwa.cpp)
        # line up with `bwa fa2pac` indices. The +1 shift happens inside
        # the native unpack (one pass, uint8 end-to-end).
        shifted = pac.read_pac(path, shift=1)
        return np.concatenate(
            [shifted, np.array([PACTERM_TERMINATOR], np.uint8)]), 5

    @classmethod
    def load_bounded(cls, path: str, spill_path: str):
        symbols, spill = _pac_unpack_bounded(path, spill_path, 1, True)
        return symbols, 5, spill


class Lz4Input(InputType):
    name = "lz4"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        data = read_lz4_stream(path)
        return np.frombuffer(data, dtype=np.uint8), 256


class Utf8Input(InputType):
    name = "utf-8"

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, int]:
        with open(path, "rb") as f:
            text = f.read().decode("utf-8")
        # the code points, through UTF-32 (a list of ord() would take
        # minutes and tens of GB at 10^8 symbols)
        codes = np.frombuffer(text.encode("utf-32-le"),
                              np.uint32).astype(np.int32)
        sigma = int(codes.max()) + 1 if len(codes) else 1
        return codes, sigma


_REGISTRY: Dict[str, Type[InputType]] = {
    cls.name: cls
    for cls in (ByteInput, CompactInput, PacInput, PacTermInput, Lz4Input, Utf8Input)
}
# accepted aliases
_REGISTRY["byte"] = ByteInput
_REGISTRY["compact"] = CompactInput
_REGISTRY["utf8"] = Utf8Input


def parse_input_type(name: str) -> Type[InputType]:
    if name not in _REGISTRY:
        raise ValueError(
            "unknown inputtype %r (expected one of %s)"
            % (name, ", ".join(sorted(set(c.name for c in _REGISTRY.values()))))
        )
    return _REGISTRY[name]


def circular_slice(text: np.ndarray, start: int, length: int) -> np.ndarray:
    """text[start : start+length] with wraparound (circular_wrapper role)."""
    n = len(text)
    idx = (start + np.arange(length)) % n
    return text[idx]


def circular_reverse_slice(text: np.ndarray, start: int, length: int) -> np.ndarray:
    """text[start], text[start-1], ... going backwards circularly
    (circular_reverse_wrapper role, upstream src/checkbwt.cpp:183)."""
    n = len(text)
    idx = (start - np.arange(length)) % n
    return text[idx]
