"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/<name>.cu`` into its own shared library
with a plain C interface, ``build/lib<name>.so``, at first use; all
sources are compiled at once, one ``nvcc`` process each, and every
library is loaded with ``ctypes``.  A library is rebuilt when its source
or a shared header (``csrc/*.cuh``) is newer than it.  No PyTorch headers
are compiled (a file that includes them takes minutes to build), so a
build takes seconds.  A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry points of each kernel library: name -> (argtypes, restype)
ENTRY_POINTS = {
    "lf_walk": {"bwt_lf_walk": ([p_, i_, p_, i_, ll_, p_, p_, p_, p_, p_, p_,
                                 i_, i_, p_, p_, p_, ll_, p_, ll_, ll_, i_,
                                 p_], i_),
                "bwt_lf_select": ([p_, i_, p_, i_] + [p_] * 5
                                  + [i_, i_, i_, p_, i_, p_], i_),
                "bwt_lf_walk_w": ([p_, i_, p_, p_, i_, ll_, p_, p_, p_, p_, p_,
                                   p_, ll_, ll_, p_, p_, p_, ll_, p_, ll_, ll_,
                                   i_, p_], i_),
                "bwt_lf_walk_wm": ([p_, ll_, i_, p_, p_, i_, i_, i_, ll_]
                                   + [p_] * 6 + [i_, i_, p_, p_, p_, ll_, p_,
                                                 ll_, ll_, i_, p_], i_),
                "bwt_l2_fetch_granularity": ([i_], i_)},
    "gap_chain": {"bwt_gap_chain_mk": ([p_, i_] + [p_] * 11 + [i_, i_, p_],
                                       i_),
                  "bwt_gap_chain_mk_w": ([p_, i_, p_, i_] + [p_] * 11
                                         + [ll_, i_, p_], i_),
                  "bwt_gap_chain_mk_wm": ([p_, ll_, i_, p_, p_, i_, i_, i_]
                                          + [p_] * 11 + [i_, i_, p_], i_)},
    "kasai": {"bwt_kasai_plcp": ([p_, p_, ll_] + [p_] * 5
                                 + [i_, ll_, ll_, ll_, i_, ll_, p_], i_)},
    "rl_decode": {"bwt_rl_decode_u8": ([p_, ll_, p_] + [ll_] * 5
                                       + [p_] * 4, i_)},
    "hwt_bits": {"bwt_hwt_tile_counts": ([p_, ll_, p_, i_, p_, p_], i_),
                 "bwt_hwt_node_words": ([p_, ll_, p_, i_, p_, p_, p_], i_)},
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, "lib%s.so" % name)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the CUDA toolkit that PyTorch
    found (``CUDA_HOME``).  Raises ``RuntimeError`` when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (not on PATH and no CUDA_HOME): the "
                       "CUDA kernels of bwtb3m_tpu_torch cannot be built")


def _name(src: str) -> str:
    return os.path.splitext(os.path.basename(src))[0]


def _stale(src: str) -> bool:
    lib = lib_path(_name(src))
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    deps = [src] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build() -> list:
    """Compile every stale kernel library, all in parallel; returns the
    library paths.

    Concurrent callers serialise on a lock file in the build directory.
    Raises ``RuntimeError`` when ``nvcc`` is missing or fails; the
    compilers' output (``-Xptxas -v``: registers, spills) is kept in
    ``build/nvcc.log``."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in _sources() if _stale(s)]
        t0 = time.monotonic()
        procs = []
        for src in todo:
            name = _name(src)
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
                   lib_path(name) + ".tmp", src]
            procs.append((name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, cmd, proc in procs:
            out, _ = proc.communicate()
            with open(LOG_PATH, "a") as f:
                f.write(" ".join(cmd) + "\n" + out)
                f.write("%s: build time %.2f s, exit code %d\n"
                        % (name, time.monotonic() - t0, proc.returncode))
            if proc.returncode != 0:
                failed.append("%s (exit %d):\n%s"
                              % (name, proc.returncode, out[-4000:]))
            else:
                os.replace(lib_path(name) + ".tmp", lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return [lib_path(_name(s)) for s in _sources()]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, load the library of ``csrc/<name>.cu`` once, and
    declare its entry points' types."""
    build()
    lib = ctypes.CDLL(lib_path(name))
    for fn, (argtypes, restype) in ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.bwt_error_string.argtypes = [ctypes.c_int]
    lib.bwt_error_string.restype = ctypes.c_char_p
    return lib
