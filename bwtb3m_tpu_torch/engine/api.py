"""Top-level BWT construction — the ``bwtb3m`` tool.

Port of ``bwtb3m_tpu/engine/api.py::compute_bwt``: load the input, build
the BWT on the device, then write ``.bwt`` (RL codec), ``.hist``,
``.preisa``, ``.meta`` and, unless ``bwtonly=1``, ``.sa``, ``.isa`` and
``.hwt``.  Texts of up to ``max_block_symbols`` take the single-block
prefix-doubling sort (``ops/doubling.py``); longer ones (``engine=auto``),
and every text with ``engine=merge`` or ``engine=merge-legacy``, take
the scaled blockwise merge engine (``engine/merge_scaled.py``), after the
reference's alphabet compaction.  With ``hostmem=`` the text never fully
materializes in host memory: it is a read-only memory map (the input
file itself for a bytestream, else a chunk-decoded spill file under
``tmpprefix``) that the host reads page by page and that goes to the
device in chunks.  After a
merge-engine build the final region's device bytes are bound to the
returned ``BwtResult`` (``engine/result.py::BwtResult.bind_device_rows``),
so a ``check_bwt`` of that result, or the build's own SA/ISA walk, builds
its rank rows from them instead of decoding the file.

The writers are the port's copies of the reference package's host modules
(``io/``), so every file is byte-identical to the reference's for the
same input; ``.meta`` keeps ``"format": "bwtb3m_tpu/v1"``, the name of
the file format.  ``bwtcodec=rlh`` writes the Huffman-coded RLH1 ``.bwt``
(``io/rlh.py``).

An alphabet of more than 256 distinct symbols (a UTF-8 text) takes the
scaled engine too, where the reference takes its legacy full-SA engine:
the text is compacted to dense ids, uint16 up to 65,536 distinct symbols
and uint32 past them, and the engine runs on 16- or 32-bit regions and
wavelet rank rows (up to 2^21 distinct symbols, 7 levels: every Unicode
code point), pair by pair, with no checkpoints
(``engine/merge_scaled.py``); the files are the reference's.  Past 256
distinct symbols the text stays below 2^31 symbols, as the reference's
int32 lanes do.

``engine=merge-legacy`` is mapped onto the scaled engine, not ported:
the reference sends it to its round-1 engine
(``bwtb3m_tpu/engine/merge.py`` over ``ops/gap.py`` and
``ops/rank_packed.py``: a full SA and ISA per block, no alphabet
compaction), whose ``.bwt``, ``.hist``, ``.preisa``, ``.sa``, ``.isa``
and ``.hwt`` are byte for byte the scaled engine's
(``tests/test_torch_merge_legacy.py`` holds the port to it), so a second
engine would compute the same files more slowly.  The
exception is a text whose rotations come in equal copies (a power of a
shorter string, poly-A): there the legacy engine's ``.sa`` orders equal
rotations by position, as the single-block sort does, and the scaled
engine's SA walk does not (in both packages), so with ``bwtonly=0``
``merge-legacy`` writes that text's samples from one sort of its root
(``_power_samples``).  Only ``merge-legacy`` takes that path because
each engine name writes its own reference engine's files: the
reference's ``engine=merge`` is the scaled engine, whose samples of
such a text ``engine=merge`` keeps as they are (ROADMAP.md Queue 3).
The root is sorted in one block, so a root of more than
``max_block_symbols`` raises ``NotImplementedError`` before the build
(Queue 3).

``engine=sharded`` runs the sharded suffix sort (``parallel/``) over the
ranks of a process group: torchrun's (``torchrun --nproc_per_node=N -m
bwtb3m_tpu_torch bwtb3m engine=sharded ...``), or a group of one.  Every
rank loads the text and sorts its shard; rank 0 writes the files that
``engine=doubling`` writes, and the other ranks return a result without
files.  ``hostmem=`` does not bound that engine: every rank holds the
whole text.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional

import numpy as np

from .. import native
from ..io import formats
from ..io.inputtypes import parse_input_type
from ..ops.doubling import suffix_array
from ..ops.wavelet_rows import MAX_SYMBOLS
from ..util.devices import resolve_device
from ..util.log import RealTimeClock, VerboseLog, mem_usage_string
from ..util.phases import Phases
from .options import BwtOptions
from .result import BwtResult, write_bwt


def _remove(path: Optional[str]) -> None:
    if path:
        try:
            os.remove(path)
        except OSError:
            pass


def _spill_text(symbols: np.ndarray, options: BwtOptions, log: VerboseLog):
    """Bounded host memory: when ``hostmem=`` is set and text + final BWT
    would exceed it, an in-memory text moves to a read-only memmap under
    tmp_prefix.  Returns (symbols, spill path or None)."""
    n = len(symbols)
    if isinstance(symbols, np.memmap):
        return symbols, None          # already bounded (load_bounded)
    if not options.host_mem or 2 * n <= options.host_mem:
        return symbols, None
    path = options.tmp_prefix + "_text.u8"
    dt = np.asarray(symbols).dtype
    if dt not in (np.uint16, np.uint32):
        dt = np.uint8
    np.asarray(symbols, dt).tofile(path)
    log.v("hostmem=%d: text (%d bytes) spilled to memmap %s"
          % (options.host_mem, n * np.dtype(dt).itemsize, path))
    return np.memmap(path, dt, "r"), path


def compute_bwt(options: BwtOptions,
                log: Optional[VerboseLog] = None) -> BwtResult:
    log = log or VerboseLog(options.verbose)
    rtc = RealTimeClock()
    device = resolve_device(options.device)

    # ---- phase 1: load input (host) -------------------------------------
    itype = parse_input_type(options.input_type)
    bounded_spill = None
    with log.span("load input (%s)" % itype.name):
        # engine=sharded: every rank holds the text (the sort takes an
        # int32 copy), and ranks on one host would share one spill file
        if options.host_mem and options.engine != "sharded":
            symbols, sigma, bounded_spill = itype.load_bounded(
                options.input_path, options.tmp_prefix + "_text.u8")
        else:
            symbols, sigma = itype.load(options.input_path)
    n = int(len(symbols))
    if n == 0:
        raise ValueError("empty input text: %s" % options.input_path)
    log.v("n=%d sigma=%d device=%s" % (n, sigma, device))

    prate = options.preisa_sampling_rate
    if prate is None:
        # adaptive: ~128k walk lanes, power-of-two, within [32, isa rate]
        target = max(1, n // (1 << 17))
        prate = 1 << max(5, (target - 1).bit_length())
        prate = min(prate, max(32, options.isa_sampling_rate))
    prate = max(1, min(prate, n))

    period = n
    if options.engine == "merge-legacy" and not options.bwt_only:
        period = _rotation_period(symbols)
        if options.max_block_symbols < period < n:
            raise NotImplementedError(
                "engine=merge-legacy bwtonly=0 on a power of a %d-symbol "
                "root: the root's sort is single-block, up to "
                "max_block_symbols=%d (ROADMAP.md Queue 3)"
                % (period, options.max_block_symbols))

    # ---- phase 2+3: suffix sort (device) -------------------------------
    phase = Phases(device)
    sa = isa = None
    rows_out: list = []     # the merge engine's device-rows hand-off
    symmap = None           # dense id -> file symbol (alphabet compaction)
    if options.engine == "sharded":
        sa, isa, bwt = _sharded_engine(symbols, sigma, device, log)
        if sa is None:          # a rank other than 0: it writes no files
            return BwtResult({"format": "bwtb3m_tpu/v1", "n": n,
                              "sigma": sigma, "files": {}})
        spos = np.arange(0, n, prate, dtype=np.int64)
        srank = isa[spos]
    elif options.engine in ("merge", "merge-legacy") or (
            options.engine == "auto" and n > options.max_block_symbols):
        bwt, spos, srank, symmap = _merge_engine(
            symbols, sigma, prate, options, device, log, phase, rows_out,
            bounded_spill)
        bounded_spill = None
    else:
        with log.span("suffix sort (single block, prefix doubling, %s) + "
                      "host inverse" % device):
            sa, isa, bwt = suffix_array(symbols, sigma, device, log)
        spos = np.arange(0, n, prate, dtype=np.int64)
        srank = isa[spos]

    # ---- phase 4: outputs (host) ---------------------------------------
    base = options.base_name
    files = {}
    with log.span("write .bwt (%s)" % options.bwt_codec), \
            phase("write .bwt"):
        if options.bwt_codec == "rlh":
            from ..io.rlh import rlh_encode
            rlh_encode(options.output_filename, bwt, sigma=sigma)
        else:
            write_bwt(options.output_filename, bwt, sigma)
        files["bwt"] = options.output_filename

    with log.span("output hist"):
        hist = np.bincount(bwt, minlength=sigma).astype(np.int64)

    def result_of(meta) -> BwtResult:
        """The result of ``meta``, with the final region's device bytes
        bound to the .bwt just written (once: the first result made takes
        them); a handle that does not describe this file is refused."""
        res = BwtResult(meta)
        if rows_out:
            try:
                res.bind_device_rows(rows_out.pop(), hist, symmap=symmap)
            except ValueError as exc:   # it saves time, it gates nothing
                log.v("[W] device-rows hand-off skipped: %s" % exc)
        return res

    formats.write_hist(base + ".hist", formats.hist_from_array(hist))
    files["hist"] = base + ".hist"
    formats.write_preisa(base + ".preisa", srank, spos, prate)
    files["preisa"] = base + ".preisa"

    def write_meta():
        meta = {
            "format": "bwtb3m_tpu/v1",
            "n": n,
            "sigma": sigma,
            "input": os.path.abspath(options.input_path),
            "inputtype": itype.name,
            "bwtonly": bool(options.bwt_only),
            "sasamplingrate": options.sa_sampling_rate,
            "isasamplingrate": options.isa_sampling_rate,
            "preisasamplingrate": prate,
            "files": files,
        }
        formats.write_meta(base + ".meta", meta)
        return meta

    # ---- phase 5: sampled SA/ISA + .hwt (bwtonly=0) --------------------
    if not options.bwt_only:
        srate = max(1, options.sa_sampling_rate)
        irate = max(1, options.isa_sampling_rate)
        if sa is not None:
            formats.write_sampled_array(base + ".sa", srate, sa[::srate])
            formats.write_sampled_array(base + ".isa", irate, isa[::irate])
        elif period < n:
            with log.span("sampled SA/ISA of a power of a %d-symbol root"
                          % period):
                ssa, sisa = _power_samples(symbols, period, sigma, srate,
                                           irate, device, log)
            formats.write_sampled_array(base + ".sa", srate, ssa)
            formats.write_sampled_array(base + ".isa", irate, sisa)
        else:
            # the merge engine keeps no full SA/ISA: the bwtcomputessa
            # walk derives the samples from .bwt + .preisa (the
            # reference's bwtonly=1 follow-up)
            from .ssa import compute_ssa
            with log.span("sampled SA/ISA via LF walk (merge engine)"):
                compute_ssa(options.output_filename, srate, irate, log=log,
                            device=device, result=result_of(write_meta()))
        files["sa"] = base + ".sa"
        files["isa"] = base + ".isa"
        from ..index.wavelet import HuffmanWaveletTree
        with log.span("write .hwt (Huffman wavelet tree)"):
            HuffmanWaveletTree.build(bwt).write(base + ".hwt")
        files["hwt"] = base + ".hwt"

    meta = write_meta()
    del symbols
    _remove(bounded_spill)
    log.v("phases (wall s): %s" % json.dumps(phase.wall))
    log.v("%s runtime %.3fs" % (mem_usage_string(), rtc.elapsed()))
    return result_of(meta)


def _rotation_period(symbols) -> int:
    """The least p dividing n with text[i] == text[(i + p) mod n] for
    every i: n, unless the text is a power u^(n/p) of a shorter root u,
    whose rotations then come in n/p equal copies.  The divisors are
    tried in increasing order, each on a 4,096-symbol prefix before the
    whole text."""
    n = len(symbols)
    divs = set()
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            divs.update((d, n // d))
    for p in sorted(divs - {n}):
        head = min(n - p, 4096)
        if np.array_equal(symbols[:head], symbols[p:p + head]) \
                and np.array_equal(symbols[:n - p], symbols[p:]):
            return p
    return n


def _power_samples(symbols, p: int, sigma: int, srate: int, irate: int,
                   device, log):
    """Sampled SA and ISA of a text u^k (k = n / p > 1, u primitive) as
    the reference's legacy engine writes them, equal rotations in
    position order: the k copies of u's s-th smallest rotation hold the
    ranks s k .. s k + k - 1, at positions SA_u[s] + j p.  (The scaled
    engine's SA walk orders equal rotations otherwise, or misses some, in
    both packages: ROADMAP.md Queue 3.)  One single-block sort of the
    root, on ``device``; ``compute_bwt`` refuses a root of more than
    ``max_block_symbols`` before the build."""
    n = len(symbols)
    k = n // p
    sa_u, isa_u, _bwt = suffix_array(np.asarray(symbols[:p]), sigma, device,
                                     log)
    r = np.arange(0, n, srate, dtype=np.int64)
    q = np.arange(0, n, irate, dtype=np.int64)
    return sa_u[r // k] + (r % k) * p, isa_u[q % p] * k + q // p


def _sharded_engine(symbols, sigma: int, device, log: VerboseLog):
    """(sa, isa, bwt) of the sharded suffix sort (``parallel/``) over the
    ranks of the group (``parallel/dist.py::initialize``: torchrun's, or
    a group of one), on rank 0; (None, None, None) on the others."""
    from ..parallel import dist as pdist
    from ..parallel.doubling import sharded_bwt
    with pdist.session(device, log=log) as mesh:
        with log.span("device suffix sort (sharded, %d ranks, %s)"
                      % (mesh.world, mesh.backend)):
            sa, _rank, bwt = sharded_bwt(symbols, sigma, mesh)
        if mesh.rank != 0:
            return None, None, None
    isa = np.zeros(len(sa), dtype=np.int64)
    isa[sa] = np.arange(len(sa), dtype=np.int64)
    return sa, isa, bwt


def _merge_engine(symbols, sigma: int, prate: int, options: BwtOptions,
                  device, log: VerboseLog, phase: Phases, rows_out: list,
                  bounded_spill: Optional[str]):
    """The scaled engine after the reference's alphabet compaction: a
    sigma > 256 alphabet with <= 256 distinct symbols compacts to bytes
    and one with more to dense uint16 ids (up to 65,536) or uint32 ids
    (up to 2^21; more raise ``ValueError``), a byte alphabet
    with <= 16 distinct symbols to nibbles (a strictly monotonic remap
    keeps rotation order, so the BWT maps back through the same table).
    A memory-mapped text (``hostmem=``) is compacted
    chunk by chunk into a second map; ``bounded_spill`` and every spill
    made here are removed when the engine returns.  Returns (bwt, preisa
    positions, preisa ranks, symmap or None)."""
    from .merge_scaled import blockwise_bwt_scaled, host_symbol_dtype

    symmap = None
    if sigma > 256:
        with log.span("alphabet compaction scan"):
            syms_np = np.asarray(symbols)
            # the distinct symbols (np.unique's) from one counting pass
            uniq = np.flatnonzero(np.bincount(syms_np, minlength=sigma))
            if len(uniq) > MAX_SYMBOLS:
                raise ValueError(
                    "the merge engine takes at most 2,097,152 (2^21) "
                    "distinct symbols, not %d" % len(uniq))
            table = np.zeros(sigma, host_symbol_dtype(len(uniq)))
            table[uniq] = np.arange(len(uniq))
            symmap = uniq.astype(np.int64)
            symbols = table[syms_np]
            del syms_np, table
        log.v("alphabet rank-compacted: %d distinct symbols" % len(uniq))
    elif sigma > 16:
        with log.span("alphabet compaction scan"):
            syms_np = np.asarray(symbols)
            uniq = np.flatnonzero(native.byte_hist(syms_np, minlength=sigma))
            if 0 < len(uniq) <= 16:
                table = np.zeros(sigma, np.uint8)
                table[uniq] = np.arange(len(uniq), dtype=np.uint8)
                symmap = uniq.astype(np.int64)
                if isinstance(symbols, np.memmap):
                    # a full fancy-index would stage the whole text
                    cpath = options.tmp_prefix + "_text_c.u8"
                    out = np.memmap(cpath, np.uint8, mode="w+",
                                    shape=symbols.shape)
                    for a in range(0, len(symbols), 1 << 26):
                        out[a:a + (1 << 26)] = table[symbols[a:a + (1 << 26)]]
                    out.flush()
                    del out, syms_np
                    _remove(bounded_spill)
                    bounded_spill = cpath
                    symbols = np.memmap(cpath, np.uint8, mode="r")
                else:
                    symbols = table[syms_np]
                log.v("alphabet rank-compacted: %d distinct symbols"
                      % len(uniq))
    eff_sigma = sigma if symmap is None else len(symmap)
    lb = options.lane_bucket or (1 << 16)
    symbols, spill_path = _spill_text(symbols, options, log)
    try:
        with log.span("device suffix sort (scaled blockwise merge, %s)"
                      % device):
            bwt, spos, srank, _hist = blockwise_bwt_scaled(
                symbols, eff_sigma, options, log, sample_rate=prate,
                lane_bucket=lb, device=device, phase=phase,
                rows_out=rows_out)
    finally:
        del symbols
        _remove(spill_path)
        _remove(bounded_spill)
    if symmap is not None:
        with log.span("symmap restore"):
            tab = symmap.astype(
                np.uint8 if int(symmap.max()) < 256 else np.int32)
            bwt = tab[bwt]
    return bwt, spos, srank, symmap


def main_bwtb3m(argv) -> int:
    """CLI entry: ``bwtb3m key=value ... <input>``."""
    from ..util.args import ArgInfo

    ai = ArgInfo(argv, progname="bwtb3m")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwtb3m inputtype=<bytestream|compactstream|pac|pacterm|"
            "lz4|utf-8> [outputfilename=..] [sasamplingrate=32] "
            "[isasamplingrate=262144] [mem=2G] [hostmem=0] [batchmerges=1] "
            "[numthreads=8] [bwtonly=0] [tmpprefix=..] [verbose=1] "
            "[device=cuda] <input>\n"
        )
        return 1
    compute_bwt(BwtOptions.from_arginfo(ai))
    return 0
