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
``merge-legacy`` writes that text's files from its root
(``_power_files``): one single-block sort of a root of up to
``max_block_symbols``, else a scaled-engine build of the root whose
samples the select and harvest visits of the LF-walk kernel take; the
text itself is never sorted.  Only ``merge-legacy`` takes that path
because each engine name writes its own reference engine's files: the
reference's ``engine=merge`` is the scaled engine, whose samples of such
a text ``engine=merge`` keeps as they are (ROADMAP.md Queue 3).

``engine=sharded`` runs the sharded suffix sort (``parallel/``) over the
ranks of a process group: torchrun's (``torchrun --nproc_per_node=N -m
bwtb3m_tpu_torch bwtb3m engine=sharded ...``), or a group of one.  Every
rank loads the text and sorts its shard; rank 0 writes the files that
``engine=doubling`` writes, and the other ranks return a result without
files.  ``hostmem=`` does not bound that engine: every rank holds the
whole text.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from .. import native
from ..io import formats
from ..io.inputtypes import parse_input_type
from ..ops.doubling import suffix_array
from ..ops.wavelet_rows import MAX_SYMBOLS
from ..util import trace
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
    with trace.span("engine.build"):
        return _compute_bwt(options, log or VerboseLog(options.verbose))


def _compute_bwt(options: BwtOptions, log: VerboseLog) -> BwtResult:
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

    srate = max(1, options.sa_sampling_rate)
    irate = max(1, options.isa_sampling_rate)
    period = n
    if options.engine == "merge-legacy" and not options.bwt_only:
        period = _rotation_period(symbols)

    # ---- phase 2+3: suffix sort (device) -------------------------------
    phase = Phases(device)
    sa = isa = None
    rows_out: list = []     # the merge engine's device-rows hand-off
    symmap = None           # dense id -> file symbol (alphabet compaction)
    if period < n:
        with log.span("power of a %d-symbol root: its files from the root"
                      % period):
            bwt, spos, srank, ssa, sisa = _power_files(
                symbols, period, sigma, prate, srate, irate, options,
                device, log, phase)
    elif options.engine == "sharded":
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
    files, hist = _write_files(options.output_filename, options.bwt_codec,
                               bwt, sigma, spos, srank, prate, phase, log)

    def result_of(meta) -> BwtResult:
        return _bound_result(meta, rows_out, hist, symmap, log)

    def write_meta():
        return _write_meta(options, itype.name, n, sigma, prate, files)

    # ---- phase 5: sampled SA/ISA + .hwt (bwtonly=0) --------------------
    if not options.bwt_only:
        if sa is not None:
            formats.write_sampled_array(base + ".sa", srate, sa[::srate])
            formats.write_sampled_array(base + ".isa", irate, isa[::irate])
        elif period < n:
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


def _write_files(bwt_path: str, codec: str, bwt, sigma: int, spos, srank,
                 prate: int, phase: Phases, log: VerboseLog):
    """A build's ``.bwt`` at ``bwt_path`` (``codec``), and its ``.hist``
    and ``.preisa`` beside it.  Returns (the files map, the histogram)."""
    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    with log.span("write .bwt (%s)" % codec), phase("write .bwt"):
        if codec == "rlh":
            from ..io.rlh import rlh_encode
            rlh_encode(bwt_path, bwt, sigma=sigma)
        else:
            write_bwt(bwt_path, bwt, sigma)
    with log.span("output hist"):
        hist = np.bincount(bwt, minlength=sigma).astype(np.int64)
    formats.write_hist(base + ".hist", formats.hist_from_array(hist))
    formats.write_preisa(base + ".preisa", srank, spos, prate)
    return ({"bwt": bwt_path, "hist": base + ".hist",
             "preisa": base + ".preisa"}, hist)


def _write_meta(options: BwtOptions, itype: str, n: int, sigma: int,
                prate: int, files: dict) -> dict:
    """Write and return the ``.meta`` beside ``files["bwt"]``."""
    meta = {
        "format": "bwtb3m_tpu/v1",
        "n": n,
        "sigma": sigma,
        "input": os.path.abspath(options.input_path),
        "inputtype": itype,
        "bwtonly": bool(options.bwt_only),
        "sasamplingrate": options.sa_sampling_rate,
        "isasamplingrate": options.isa_sampling_rate,
        "preisasamplingrate": prate,
        "files": files,
    }
    bwt_path = files["bwt"]
    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    formats.write_meta(base + ".meta", meta)
    return meta


def _bound_result(meta, rows_out: list, hist, symmap,
                  log: VerboseLog) -> BwtResult:
    """The result of ``meta``, with the merge engine's final region's
    device bytes bound to the .bwt just written (once: the first result
    made takes them); a handle that does not describe this file is
    refused."""
    res = BwtResult(meta)
    if rows_out:
        try:
            res.bind_device_rows(rows_out.pop(), hist, symmap=symmap)
        except ValueError as exc:   # it saves time, it gates nothing
            log.v("[W] device-rows hand-off skipped: %s" % exc)
    return res


_PERIOD_CHUNK = 1 << 24     # symbols a whole-text period check compares at once


def _rotation_period(symbols) -> int:
    """The least p dividing n with text[i] == text[(i + p) mod n] for
    every i: n, unless the text is a power u^(n/p) of a shorter root u,
    whose rotations then come in n/p equal copies.  The divisors are
    tried in increasing order, each on a 4,096-symbol prefix before the
    whole text, which is compared ``_PERIOD_CHUNK`` symbols at a time (a
    memory-mapped text is read page by page, never whole)."""
    n = len(symbols)
    divs = set()
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            divs.update((d, n // d))
    for p in sorted(divs - {n}):
        head = min(n - p, 4096)
        if np.array_equal(symbols[:head], symbols[p:p + head]) and all(
                np.array_equal(symbols[a:min(a + _PERIOD_CHUNK, n - p)],
                               symbols[a + p:min(a + _PERIOD_CHUNK + p, n)])
                for a in range(0, n - p, _PERIOD_CHUNK)):
            return p
    return n


def _power_files(symbols, p: int, sigma: int, prate: int, srate: int,
                 irate: int, options: BwtOptions, device, log,
                 phase: Phases):
    """Every file of a text t = u^k (k = n / p > 1, u primitive) from its
    root, as the reference's legacy engine writes them, equal rotations
    in position order: the k copies of u's s-th smallest rotation hold
    the ranks s k .. s k + k - 1, at positions SA_u[s] + j p, so

        SA_t[s k + j] = SA_u[s] + j p,   BWT_t[s k + j] = BWT_u[s],
        ISA_t[q] = ISA_u[q mod p] k + q // p.

    (The scaled engine orders equal rotations otherwise in its SA walk,
    in both packages, and on t its anchors walk back across every copy
    of u: ROADMAP.md Queue 3.)  Returns (BWT_t, the .preisa positions
    0, prate, ... and their ranks, the sampled SA at srate and ISA at
    irate).  A root of up to ``max_block_symbols`` takes one
    single-block sort on ``device`` (``_power_files_single``), a longer
    one a scaled-engine build (``_power_files_scaled``, its phases timed
    in ``phase``)."""
    if p <= options.max_block_symbols:
        return _power_files_single(symbols, p, sigma, prate, srate, irate,
                                   device, log)
    return _power_files_scaled(symbols, p, sigma, prate, srate, irate,
                               options, device, log, phase)


def _power_isa(isa_at, g: int, p: int, k: int, n: int, rate: int):
    """ISA_t at the positions 0, rate, 2 rate, ... < n from ``isa_at``, a
    tensor of ISA_u at the multiples of g (g divides gcd(rate, p)),
    gathered where it lies: only these n / rate values reach the host."""
    q = np.arange(0, n, rate, dtype=np.int64)
    at = torch.from_numpy((q % p) // g).to(isa_at.device)
    isa = isa_at[at].cpu().numpy()
    if (isa < 0).any():
        raise AssertionError("the root's harvest walk failed to visit "
                             "every sampled position")
    return isa * k + q // p


def _power_files_single(symbols, p: int, sigma: int, prate: int,
                        srate: int, irate: int, device, log):
    """``_power_files`` from one single-block sort of the root."""
    n = len(symbols)
    k = n // p
    sa_u, isa_u, bwt_u = suffix_array(np.asarray(symbols[:p]), sigma, device,
                                      log)
    isa_u = torch.from_numpy(isa_u)
    r = np.arange(0, n, srate, dtype=np.int64)
    return (np.repeat(bwt_u, k), np.arange(0, n, prate, dtype=np.int64),
            _power_isa(isa_u, 1, p, k, n, prate), sa_u[r // k] + (r % k) * p,
            _power_isa(isa_u, 1, p, k, n, irate))


def _power_files_scaled(symbols, p: int, sigma: int, prate: int,
                        srate: int, irate: int, options: BwtOptions,
                        device, log, phase: Phases):
    """``_power_files`` of a root past one block, whose SA and ISA the
    host never holds: the root is built by the scaled engine (the build's
    alphabet compaction, ``mem=`` and ``hostmem=``; ``<output>.stop``
    stops it as it stops the build) into ``<tmp_prefix>_root.*`` with a
    ``.preisa`` at the build's rate.  Its SA at the n / srate ranks
    s = r // k comes from the select visit (``engine/ssa.py::select_ssa``).
    Its ISA at the positions q mod p of the ``.preisa`` and ``.isa``
    positions q, all multiples of g = gcd(irate, prate, p), comes from
    the harvest visit at ISA rate g: the p / g values stay on the device,
    which gathers the n / prate + n / irate that the files take.  Past
    256 symbols, or from 2^32 root symbols, ``select_ssa`` answers
    through the FM index's locate, which reads a sampled ``.sa``: the
    harvest then also samples the root's SA (at a power of two of at
    least max(srate, 4), n / srate values) and writes it.  The root's
    files are removed on the way out."""
    from .result import clear_caches
    from .ssa import _harvest, select_ssa

    n = len(symbols)
    k = n // p
    g = math.gcd(math.gcd(irate, prate), p)
    rprate = min(prate, p)
    base = options.tmp_prefix + "_root"
    # the root's checkpoints are its own; its stop file is the build's
    ropts = dataclasses.replace(options, tmp_prefix=base + "_tmp")
    rmeta = dataclasses.replace(options, bwt_only=True)
    itype = parse_input_type(options.input_type).name
    try:
        rows_out: list = []
        with log.span("root of %d symbols: scaled build" % p):
            bwt_u, spos, srank, symmap = _merge_engine(
                symbols[:p], sigma, rprate, ropts, device, log, phase,
                rows_out, None)
            files, hist = _write_files(base + ".bwt", "rl", bwt_u, sigma,
                                       spos, srank, rprate, phase, log)
            meta = _write_meta(rmeta, itype, p, sigma, rprate, files)
            del spos, srank
        root = _bound_result(meta, rows_out, hist, symmap, log)
        need_sa = sigma > 256 or p >= 1 << 32
        rsrate = 1 << max(2, (srate - 1).bit_length()) if need_sa else p
        with log.span("root ISA at rate %d (harvest visit)" % g):
            sa_r, isa_r, _lanes = _harvest(root, rsrate, g, device, log)
            pisa = _power_isa(isa_r, g, p, k, n, prate)
            sisa = _power_isa(isa_r, g, p, k, n, irate)
            del isa_r
        if need_sa:
            sa_r = sa_r.cpu().numpy()
            if (sa_r < 0).any():
                raise AssertionError("the root's harvest walk failed to "
                                     "visit every sampled rank")
            files["sa"] = base + ".sa"
            formats.write_sampled_array(files["sa"], rsrate, sa_r)
            _write_meta(rmeta, itype, p, sigma, rprate, files)
        del sa_r
        r = np.arange(0, n, srate, dtype=np.int64)
        s = r // k
        want = np.unique(s)
        with log.span("root SA at %d ranks (select)" % len(want)):
            sa_u = select_ssa(files["bwt"], want, log=log, device=device)
        ssa = sa_u[np.searchsorted(want, s)] + (r % k) * p
        del s, want, sa_u
        return (np.repeat(bwt_u, k), np.arange(0, n, prate, dtype=np.int64),
                pisa, ssa, sisa)
    finally:
        clear_caches()
        for ext in (".bwt", ".hist", ".preisa", ".preisa.meta", ".sa",
                    ".meta"):
            _remove(base + ext)


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
