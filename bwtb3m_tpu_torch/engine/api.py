"""Top-level BWT construction — the ``bwtb3m`` tool.

Port of ``bwtb3m_tpu/engine/api.py::compute_bwt``: load the input, build
the BWT on the device, then write ``.bwt`` (RL codec), ``.hist``,
``.preisa``, ``.meta`` and, unless ``bwtonly=1``, ``.sa``, ``.isa`` and
``.hwt``.  Texts of up to ``max_block_symbols`` take the single-block
prefix-doubling sort (``ops/doubling.py``); longer ones (``engine=auto``),
and every text with ``engine=merge``, take the scaled blockwise merge
engine (``engine/merge_scaled.py``), after the reference's alphabet
compaction.  The writers are the reference package's own host modules,
so every file is byte-identical to the reference's for the same input;
``.meta`` keeps ``"format": "bwtb3m_tpu/v1"``, the name of the file
format.

Not ported yet (they raise ``NotImplementedError`` naming their
ROADMAP.md item): ``engine=merge-legacy``, the sharded engine, the wide
merge path, ``bwtcodec=rlh`` and ``hostmem=``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np

from bwtb3m_tpu import native
from bwtb3m_tpu.io import formats
from bwtb3m_tpu.io.inputtypes import parse_input_type
from bwtb3m_tpu.util.log import RealTimeClock, VerboseLog, mem_usage_string

from ..ops.doubling import suffix_array
from ..util.devices import resolve_device
from ..util.phases import Phases
from .options import BwtOptions
from .result import BwtResult, write_bwt


def _refuse_unported(options: BwtOptions) -> None:
    if options.engine == "sharded":
        raise NotImplementedError(
            "engine=sharded is not ported yet: ROADMAP.md Queue 1 item 9")
    if options.engine == "merge-legacy":
        raise NotImplementedError(
            "engine=merge-legacy is not ported (it becomes an alias of the "
            "scaled engine): ROADMAP.md Queue 1 item 10")
    if options.bwt_codec == "rlh":
        raise NotImplementedError(
            "bwtcodec=rlh is not ported yet: ROADMAP.md Queue 1 item 8")
    if options.host_mem:
        raise NotImplementedError(
            "hostmem= (bounded host memory) is not ported yet: ROADMAP.md "
            "Queue 1 item 4")


def compute_bwt(options: BwtOptions,
                log: Optional[VerboseLog] = None) -> BwtResult:
    log = log or VerboseLog(options.verbose)
    rtc = RealTimeClock()
    _refuse_unported(options)
    device = resolve_device(options.device)

    # ---- phase 1: load input (host) -------------------------------------
    itype = parse_input_type(options.input_type)
    with log.span("load input (%s)" % itype.name):
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

    # ---- phase 2+3: suffix sort (device) -------------------------------
    phase = Phases(device)
    sa = isa = None
    if options.engine == "merge" or (options.engine == "auto"
                                     and n > options.max_block_symbols):
        bwt, spos, srank = _merge_engine(symbols, sigma, prate, options,
                                         device, log, phase)
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
        write_bwt(options.output_filename, bwt, sigma)
        files["bwt"] = options.output_filename

    with log.span("output hist"):
        hist = np.bincount(bwt, minlength=sigma).astype(np.int64)
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
        else:
            # the merge engine keeps no full SA/ISA: the bwtcomputessa
            # walk derives the samples from .bwt + .preisa (the
            # reference's bwtonly=1 follow-up)
            write_meta()
            from .ssa import compute_ssa
            with log.span("sampled SA/ISA via LF walk (merge engine)"):
                compute_ssa(options.output_filename, srate, irate, log=log,
                            device=device)
        files["sa"] = base + ".sa"
        files["isa"] = base + ".isa"
        from ..index.wavelet import HuffmanWaveletTree
        with log.span("write .hwt (Huffman wavelet tree)"):
            HuffmanWaveletTree.build(bwt).write(base + ".hwt")
        files["hwt"] = base + ".hwt"

    meta = write_meta()
    log.v("phases (wall s): %s" % json.dumps(phase.wall))
    log.v("%s runtime %.3fs" % (mem_usage_string(), rtc.elapsed()))
    return BwtResult(meta)


def _merge_engine(symbols, sigma: int, prate: int, options: BwtOptions,
                  device, log: VerboseLog, phase: Phases):
    """The scaled engine after the reference's alphabet compaction: a
    sigma > 256 alphabet with <= 256 distinct symbols compacts to bytes,
    a byte alphabet with <= 16 distinct symbols to nibbles (a strictly
    monotonic remap keeps rotation order, so the BWT maps back through
    the same table).  Returns (bwt, preisa positions, preisa ranks)."""
    from .merge_scaled import blockwise_bwt_scaled

    symmap = None
    if sigma > 256:
        uniq = np.unique(np.asarray(symbols))
        if len(uniq) > 256:
            raise NotImplementedError(
                "the merge engine for more than 256 distinct symbols (the "
                "sigma > 256 rank path) is not ported yet: ROADMAP.md "
                "Queue 1 item 8")
        symmap = uniq
        symbols = np.searchsorted(uniq, np.asarray(symbols)).astype(np.uint8)
        log.v("alphabet rank-compacted: %d distinct symbols" % len(uniq))
    elif sigma > 16:
        with log.span("alphabet compaction scan"):
            syms_np = np.asarray(symbols)
            uniq = np.flatnonzero(native.byte_hist(syms_np, minlength=sigma))
            if 0 < len(uniq) <= 16:
                table = np.zeros(sigma, np.uint8)
                table[uniq] = np.arange(len(uniq), dtype=np.uint8)
                symmap = uniq.astype(np.int64)
                symbols = table[syms_np]
                log.v("alphabet rank-compacted: %d distinct symbols"
                      % len(uniq))
    eff_sigma = sigma if symmap is None else len(symmap)
    lb = options.lane_bucket or (1 << 16)
    with log.span("device suffix sort (scaled blockwise merge, %s)"
                  % device):
        bwt, spos, srank, _hist = blockwise_bwt_scaled(
            symbols, eff_sigma, options, log, sample_rate=prate,
            lane_bucket=lb, device=device, phase=phase)
    if symmap is not None:
        with log.span("symmap restore"):
            tab = symmap.astype(
                np.uint8 if int(symmap.max()) < 256 else np.int32)
            bwt = tab[bwt]
    return bwt, spos, srank


def main_bwtb3m(argv) -> int:
    """CLI entry: ``bwtb3m key=value ... <input>``."""
    from bwtb3m_tpu.util.args import ArgInfo

    ai = ArgInfo(argv, progname="bwtb3m")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwtb3m inputtype=<bytestream|compactstream|pac|pacterm|"
            "lz4|utf-8> [outputfilename=..] [sasamplingrate=32] "
            "[isasamplingrate=262144] [mem=2G] [numthreads=8] [bwtonly=0] "
            "[tmpprefix=..] [verbose=1] [device=cuda] <input>\n"
        )
        return 1
    compute_bwt(BwtOptions.from_arginfo(ai))
    return 0
