"""Native C++ codec loader of the port.

The port's own copy of ``bwtb3m_tpu/native``: compiles
``bwtb3m_native.cpp`` with g++ at first use into
``bwtb3m_tpu_torch/build/`` (under a per-process temporary name, then
``os.replace``, so concurrent processes cannot clobber each other's
build), binds it via ctypes, and exposes numpy-typed wrappers.  On the
CPU path every entry point has a pure-Python fallback at its call site:
importers use ``get_lib()`` and handle None.  A CUDA run calls
``require_lib()`` (``util/devices.py::resolve_device``), which raises
when the library cannot be built: the numpy fallbacks are minutes slower
at the sizes a GPU run has.

Only the entry points the port calls are here; ``sais``,
``gap_interleave``, ``gt0`` and ``pack_bits_u8`` come with the slices
that need them (ROADMAP.md).  ``cmp_rot`` also takes a uint16 or uint32
text (the merge engine's dense ids past 256 and past 65,536 distinct
symbols), which the reference's does not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bwtb3m_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_SO = os.path.join(BUILD_DIR, "_bwtb3m_native.so")

_lock = threading.Lock()
_lib = None
_tried = False
_error = "not built yet"


def _build() -> bool:
    """Compile into a temporary file of this process's own inside the
    build directory, then move it into place atomically."""
    global _error
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="_bwtb3m_native.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        out = getattr(exc, "stderr", None) or b""
        _error = "%s: %s" % (exc, out[-2000:].decode(errors="replace"))
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as exc:
            _error = str(exc)
            return None
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        pi8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.c_lz4_compress.argtypes = [pu8, i64, pu8, i64]
        lib.c_lz4_compress.restype = i64
        lib.c_lz4_decompress.argtypes = [pu8, i64, pu8, i64]
        lib.c_lz4_decompress.restype = i64
        lib.c_gamma_decode.argtypes = [pu8, i64, i64, pu64]
        lib.c_gamma_decode.restype = i64
        lib.c_cmp_rot.argtypes = [pu8, i64, i64, p64, i64, i64, pi8]
        lib.c_cmp_rot.restype = None
        pu16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.c_cmp_rot_u16.argtypes = [pu16, i64, i64, p64, i64, i64, pi8]
        lib.c_cmp_rot_u16.restype = None
        pu32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.c_cmp_rot_u32.argtypes = [pu32, i64, i64, p64, i64, i64, pi8]
        lib.c_cmp_rot_u32.restype = None
        p32i = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.c_rlh_decode.argtypes = [pu8, i64, i64, pu32, pu8, i64, p32i,
                                     p64]
        lib.c_rlh_decode.restype = i64
        lib.c_hist_u8.argtypes = [pu8, i64, i64, p64]
        lib.c_hist_u8.restype = None
        lib.c_unpack_pac.argtypes = [pu8, i64, ctypes.c_int, i64, pu8]
        lib.c_unpack_pac.restype = None
        lib.c_rl_encode_u8.argtypes = [ctypes.c_char_p, pu8, i64, u32, u32]
        lib.c_rl_encode_u8.restype = i64
        lib.c_rl_decode_u8.argtypes = [ctypes.c_char_p, pu8, i64]
        lib.c_rl_decode_u8.restype = i64
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.c_kasai_plcp.argtypes = [p32, p64, i64, p64]
        lib.c_kasai_plcp.restype = None
        _lib = lib
        return _lib


def require_lib():
    """The loaded library; raises ``RuntimeError`` with the compiler's
    message where ``get_lib()`` would return None."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native host library of bwtb3m_tpu_torch "
                           "could not be built or loaded: " + _error)
    return lib


# ---------------------------------------------------------------- wrappers

def lz4_compress(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 255 + 64
    dst = np.zeros(cap, dtype=np.uint8)
    size = lib.c_lz4_compress(np.ascontiguousarray(src), len(src), dst, cap)
    if size < 0:
        return None
    return dst[:size].tobytes()


def lz4_decompress(data: bytes, usize: int) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.zeros(max(1, usize), dtype=np.uint8)
    size = lib.c_lz4_decompress(np.ascontiguousarray(src), len(src), dst, usize)
    if size != usize:
        return None
    return dst[:usize].tobytes()


def rl_encode_u8(path: str, symbols: np.ndarray, sigma: int,
                 block_size: int) -> bool:
    """Stream-speed RLB1 writer (sigma <= 256). Returns False without the
    native lib (caller falls back to the numpy encoder)."""
    lib = get_lib()
    if lib is None or sigma > 256:
        return False
    syms = np.ascontiguousarray(symbols, dtype=np.uint8)
    rc = lib.c_rl_encode_u8(path.encode(), syms, len(syms), sigma,
                            block_size)
    return rc == 0


def rl_decode_u8(path: str, n: int):
    """Whole-file RLB1 decode to uint8; None without the native lib or on
    wide-symbol files."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(max(1, n), dtype=np.uint8)
    rc = lib.c_rl_decode_u8(path.encode(), out, len(out))
    if rc != n:
        return None
    return out[:n]


def cmp_rot(text: np.ndarray, n: int, e: int, xs: np.ndarray,
            nthreads: int = 4) -> Optional[np.ndarray]:
    """Three-way circular compare sign(rot(x) - rot(e)) for each x in xs.
    text: the plain uint8 text, or a uint16 or uint32 one (n symbols;
    spans wrap modularly in C).  Returns int8 [len(xs)] or None without
    the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    out = np.zeros(max(1, len(xs)), dtype=np.int8)
    if len(xs):
        dt = np.asarray(text).dtype
        if dt in (np.uint16, np.uint32):
            fn = lib.c_cmp_rot_u16 if dt == np.uint16 else lib.c_cmp_rot_u32
            fn(np.ascontiguousarray(text), n, e, xs, len(xs), nthreads, out)
        else:
            lib.c_cmp_rot(np.ascontiguousarray(text, np.uint8), n, e,
                          xs, len(xs), nthreads, out)
    return out[: len(xs)]


def rlh_decode_runs(payload: bytes, nbits: int, nruns: int,
                    canon_syms: np.ndarray, canon_lens: np.ndarray):
    """Decode huffman+gamma run pairs; None if no native lib or error."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(payload, dtype=np.uint8)
    run_syms = np.zeros(max(1, nruns), dtype=np.int32)
    run_lens = np.zeros(max(1, nruns), dtype=np.int64)
    used = lib.c_rlh_decode(
        np.ascontiguousarray(data), nbits, nruns,
        np.ascontiguousarray(canon_syms, np.uint32),
        np.ascontiguousarray(canon_lens, np.uint8),
        len(canon_syms), run_syms, run_lens)
    if used < 0:
        return None
    return run_syms[:nruns], run_lens[:nruns]


def hist_u8(text: np.ndarray, nthreads: int = 8,
            minlength: int = 256) -> Optional[np.ndarray]:
    """int64 symbol histogram of a uint8 array (multithreaded C).
    Returns int64 [max(256, minlength)] or None."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text, np.uint8)
    out = np.zeros(256, np.int64)
    if len(t):
        lib.c_hist_u8(t, len(t), nthreads, out)
    if minlength > 256:
        out = np.concatenate([out, np.zeros(minlength - 256, np.int64)])
    return out


def byte_hist(text: np.ndarray, minlength: int = 256,
              nthreads: int = 8) -> np.ndarray:
    """hist_u8 with a numpy fallback (always returns an array)."""
    out = hist_u8(text, nthreads=nthreads, minlength=minlength)
    if out is not None:
        return out
    return np.bincount(np.asarray(text, np.uint8),
                       minlength=max(256, minlength)).astype(np.int64)


def unpack_pac(payload: np.ndarray, n: int, shift: int = 0,
               nthreads: int = 4) -> Optional[np.ndarray]:
    """BWA .pac payload bytes -> n uint8 base codes (+shift). Returns
    None when the native library is unavailable (callers fall back to
    the numpy broadcast in io/pac.py)."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    nbytes = (n + 3) // 4
    if nbytes > len(payload):
        raise ValueError("pac payload shorter than base count")
    out = np.empty(max(1, nbytes * 4), dtype=np.uint8)
    lib.c_unpack_pac(payload, nbytes, shift, nthreads, out)
    return out[:n]


def gamma_decode(bits: np.ndarray, count: int):
    """Decode gamma codes from a 0/1 bit array; None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.packbits(np.ascontiguousarray(bits, np.uint8),
                         bitorder="little")
    out = np.zeros(max(1, count), dtype=np.uint64)
    used = lib.c_gamma_decode(packed, len(bits), count, out)
    if used < 0:
        return None
    return out[:count]


def kasai_plcp(text: np.ndarray, sa: np.ndarray) -> Optional[np.ndarray]:
    """Phi/Kasai PLCP (int64) of the circular text; None without the
    native library."""
    lib = get_lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int32)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    out = np.zeros(len(text), dtype=np.int64)
    lib.c_kasai_plcp(text, sa, len(text), out)
    return out
