#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``bwtb3m_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--n 100000003] [--merge-n 400000009]
                          [--genome-n 1200000011] [--genome-hostmem 0]

Phases, in order; any failure exits non-zero and no result line is
printed:

1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
   and the port's native host library (g++), which must have built;
2. build both kernel libraries from ``bwtb3m_tpu_torch/csrc`` (one nvcc
   each, in parallel): the LF walk (``bwt_lf_walk``) and the gap chain
   (``bwt_gap_chain_mk``: a single pair merge is a level of one);
3. the LF-walk kernel through each of its entry points (final rank,
   verify visit, harvest visit, select visit) against its plain PyTorch
   version on the
   card, bit-exact, at n = 2^22 with 131,072 lanes, on every rank-row
   layout: sector and bit-plane rows (sigma 4), bit-plane rows (sigma 7)
   and byte rows (sigma 200); then, kernel only, the walk's step rate
   on sector and bit-plane rows of 2^24 and 2^28 random symbols at 2^15
   to 2^18 lanes (rank rows inside and far past the L2);
4. the gap-chain kernel (recording form and both anchor bounds) against
   its plain version, bit-exact: a right region of 2^22 ranks, a left
   block of 2^22 symbols, 65,536 lanes, on the same four layouts; the
   runner's own anchors and chains must then give the ranks of the sort;
5. the single-block path through the CLI dispatch with ``device=cuda``
   on a chromosome-sized text (n = 100,000,003 ACGT symbols from
   ``--seed``, random except for 1,000 copies of 1,000-10,000-symbol
   segments with 1% point mutations): ``bwtb3m``; ``checkbwt`` (gok=1);
   ``checkbwt`` on a copy with one BWT symbol changed (gok=0);
   ``bwtcomputessa`` held against the build's own .sa/.isa;
6. an independent SA check at 2^22: on a text with a unique smallest
   terminator the circular suffix order equals the plain suffix order,
   which a short numpy prefix doubling (``np.lexsort``) computes here;
7. the LF-walk kernel against its plain version at step 5's shapes, on
   sector rows (what the tools run) and, in turns within the same run,
   on bit-plane rows built from the same BWT;
8. engine against engine at 16,777,259 symbols: ``bwtb3m engine=merge
   mem=67108864`` (five blocks, three levels, a carried region) gives
   the same .bwt/.hist/.preisa bytes as ``engine=doubling``;
9. the merge path at n = 400,000,009 (three blocks of the default
   mem=2G, two merges, checkpointing on): ``bwtb3m bwtonly=1`` (engine
   auto takes the scaled engine), ``checkbwt`` (gok=1), ``bwtcomputessa``
   whose .sa/.isa must agree with the build's .preisa (pos, rank) pairs;
   then the LF-walk kernel against its plain version on that build's
   seeds and segments (the shapes checkbwt and bwtcomputessa gave it),
   on sector and on bit-plane rows;
10. the gap-chain kernel against its plain version at the root merge's
    shapes (268,435,456-symbol left block, 131,564,553-rank right
    region, 65,536 lanes), on sector and on bit-plane rows; then, kernel
    only: the anchor form over the root's lanes at their full length
    (the recording walk without the histogram atomic and the sample
    write), the recording form at 2^15 to 2^18 lanes, and both with
    ``cudaLimitMaxL2FetchGranularity`` at its default and at 32;
11. the genome path at n = 1,200,000,011 (a vertebrate genome of the
    1.0-1.2 Gbp class; nine blocks at the default mem=2G: levels of 4
    pairs + a carried block, 2 pairs + carry, 1 + carry, root): ``bwtb3m
    bwtonly=0 sasamplingrate=32 isasamplingrate=262144`` (a level of two
    or more pairs is one launch of the chain, the SA/ISA walk takes its
    rank rows from the build's device symbols); ``checkbwt`` in the
    same process and once more in a fresh process from ``.bwt`` (gok=1);
    ``hwtPreIsaToIsa`` (its .isa equals the build's); ``select_ssa`` of
    2^20 ranks held against the .sa samples they name.  Then every
    kernel of that path against its plain version at the shapes the path
    gave it: the select visit on all 2^20 lanes; the verify and harvest
    walks on checkbwt's and the SA/ISA walk's lanes over the 1.2G rows;
    and ``bwt_gap_chain_mk`` (recording form and both anchor bounds) on
    every level of the build (4, 2, 1 and 1 merges), for which the build
    runs once more through the engine with each level's lanes replayed
    through the kernel and the plain version.  That replay also holds
    the peak device memory of every block sort and level to the figures
    the engine's gates plan with.  Between the two: the same build with
    ``batchmerges=0`` through ``compute_bwt`` (byte-identical files,
    phases and chain times side by side) and ``check_bwt`` of the result
    it returned, which must take the build's device symbols (the
    hand-off) and not decode the file.  ``--genome-n`` of 2^31 or more
    builds with ``bwtonly=1`` and stops after the build: checkbwt and
    the SA tools need the wide lanes there, which are not ported;
12. launch counts per path (> 0), kernel times against plain versions
    and bounds, per-phase wall and device time, peak device memory.

The last three lines are the nvidia-smi line, a JSON object of the
kernels, and ``{"ok": true, "device": {...}}``.  A kernel's ``ms``,
``plain_ms`` and ``bound_ms`` there are from the merge path's shapes
(the 400M build's walks; the root merge's chains and anchors, one merge
per launch) or, for ``gap_chain_mk`` (the same entry at the genome
build's first level of four merges; ``levels`` has every level) and the
select visit, the genome path's, on the layout that path runs;
``launches`` is that path's count and ``layouts`` has the same numbers
per layout.
``bound_ms`` is the larger of the bytes the call must move once (rank
rows, the text and gt bytes walked, lane arrays, outputs) over 3.35 TB/s
and its integer operations (steps taken times the operations of one
step, counted from the kernel source) over 67 T operations/s, the
card's float32 rate outside the tensor cores, taken for integer
operations too.  The script imports nothing of JAX and nothing of the
JAX package, and refuses both.
"""

import argparse
import contextlib
import importlib.abc
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_out")
# name -> (source, what it replaces).  lf_walk is the port of the repo's
# one pl.pallas_call; checkbwt and bwtcomputessa run it with a verify /
# harvest visit in place of the reference's XLA walks.  gap_chain ports
# the merge engine's XLA chain and anchor programs.
KERNELS = {
    "lf_walk": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                "bwtb3m_tpu/ops/lf_pallas.py:97"),
    # one entry, bwt_gap_chain_mk, ports both chain programs: the single
    # pair merge is a level of one.  The first row is that entry as the
    # merge path drives it (one merge per launch), the second as the
    # genome path does (its levels of four, two, one and one merges)
    "gap_chain": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                  "bwtb3m_tpu/ops/gapdev.py:141"),
    "gap_chain_mk": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                     "bwtb3m_tpu/ops/gapbatch.py:214"),
    # the select visit of the LF-walk kernel, counted on its own
    "lf_walk_select": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                       "bwtb3m_tpu/engine/ssa.py:468"),
}
LIBRARIES = ("lf_walk", "gap_chain")
# the path whose launches and shapes a row of the kernels line reports
ROW_PATH = {"lf_walk": "merge path", "gap_chain": "merge path",
            "gap_chain_mk": "genome path", "lf_walk_select": "genome path"}
PHASE_PREFIX = "bwtb3m::"
BLOCKED = ("jax", "jaxlib", "bwtb3m_tpu")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
OPS_PER_S = 67e12               # float32 outside the tensor cores
# integer operations of one step, counted from csrc/focc_rows.cuh and the
# kernels' loops (loads excluded): the row's count and select, the walk's
# own bookkeeping
LF_STEP_OPS = {"sector": 45, "bitplane": 165, "bytes": 150}
CHAIN_STEP_OPS = {"sector": 50, "bitplane": 150, "bytes": 160}


class _BlockJax(importlib.abc.MetaPathFinder):
    """The port and this script run without JAX and without the JAX
    package: refuse both outright (the top-level name exactly, so
    ``bwtb3m_tpu_torch`` passes)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("not used by the port: " + name)
        return None


def say(msg=""):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def make_text(n: int, seed: int):
    """ACGT text with 1,000 mutated copies of its own segments."""
    import numpy as np
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, np.uint8)]
    for _ in range(1000):
        ln = int(rng.integers(1000, 10001))
        src, dst = rng.integers(0, n - ln, 2)
        seg = text[src:src + ln].copy()
        mut = rng.random(ln) < 0.01
        seg[mut] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(mut.sum()))]
        text[dst:dst + ln] = seg
    return text


def numpy_sa(text):
    """Suffix array of a text that ends in a unique smallest symbol: prefix
    doubling on (rank, next rank) pairs with ``np.lexsort``, an
    implementation independent of the port's."""
    import numpy as np
    n = len(text)
    rank = text.astype(np.int64)
    k = 1
    while True:
        nxt = np.full(n, -1, np.int64)
        nxt[:n - k] = rank[k:]
        sa = np.lexsort((nxt, rank))
        r, x = rank[sa], nxt[sa]
        rank = np.empty(n, np.int64)
        rank[sa] = np.cumsum(np.r_[0, (r[1:] != r[:-1]) | (x[1:] != x[:-1])])
        if rank[sa[-1]] == n - 1:
            return sa
        k *= 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=100_000_003,
                    help="single-block path text length (chromosome scale)")
    ap.add_argument("--merge-n", type=int, default=400_000_009,
                    help="merge path text length (above every chromosome)")
    ap.add_argument("--merge-mem", type=int, default=2 * 1024 ** 3,
                    help="mem= of the merge path (the default gives three "
                    "blocks at the default --merge-n)")
    ap.add_argument("--genome-n", type=int, default=1_200_000_011,
                    help="genome path text length (nine blocks at mem=2G)")
    ap.add_argument("--genome-mem", type=int, default=2 * 1024 ** 3,
                    help="mem= of the genome path (blocks of mem/16 symbols)")
    ap.add_argument("--genome-hostmem", type=int, default=0,
                    help="hostmem= of the genome path's builds (0: unset)")
    args = ap.parse_args()
    sys.meta_path.insert(0, _BlockJax())

    import numpy as np
    import torch

    # ---- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    say("gpu: %s | torch %s, CUDA %s, %d device(s)"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))

    from bwtb3m_tpu_torch import native
    from bwtb3m_tpu_torch.cli import dispatch
    from bwtb3m_tpu_torch.engine import merge_scaled
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.engine.result import BwtResult, write_bwt
    from bwtb3m_tpu_torch.engine.ssa import (load_sampled_array,
                                             seed_segments, select_ssa)
    from bwtb3m_tpu_torch.engine.verify import check_bwt
    from bwtb3m_tpu_torch.ops import _build
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    from bwtb3m_tpu_torch.ops import lf_walk as lw
    from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
    from bwtb3m_tpu_torch.ops.doubling import suffix_array
    from bwtb3m_tpu_torch.ops.focc import access
    from bwtb3m_tpu_torch.ops.focc_build import (build_focc_concat,
                                                 build_focc_device,
                                                 build_focc_host)
    from bwtb3m_tpu_torch.util.args import ArgInfo
    from bwtb3m_tpu_torch.util.log import VerboseLog
    from bwtb3m_tpu_torch.util.phases import Phases

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    say("nvcc: %s" % next((v for v in ver if "release" in v), ver[-1]))
    # the host codecs and the gt comparator: their numpy stand-ins would
    # turn seconds into minutes without failing anything
    t0 = time.monotonic()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)   # native's too
    if native.get_lib() is None:
        raise SystemExit("chip_smoke: the native host library did not "
                         "build: " + native._error)
    say("native host library: %s built by g++ in %.2f s"
        % (os.path.relpath(native._SO, REPO), time.monotonic() - t0))

    # ---- 2. build -------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build()
    say("build: %s in %.2f s (%s, one nvcc per source in parallel)"
        % (", ".join(os.path.relpath(p, REPO) for p in libs),
           time.monotonic() - t0, " ".join(_build.ARCH_FLAGS)))
    with open(_build.LOG_PATH) as f:
        for line in f:
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "build time" in line):
                say("  ptxas: " + line.strip())
    for name in LIBRARIES:
        _build.load(name)

    def reset_counts():
        lw.reset_launch_counts()
        gb.reset_launch_counts()

    def counts():
        chain = gb.LAUNCHES["chain"] + gb.LAUNCHES["anchor"]
        return {"lf_walk": lw.lf_walk.launches - lw.LAUNCHES["select"],
                "lf_walk_select": lw.LAUNCHES["select"],
                "gap_chain": chain, "gap_chain_mk": chain,
                "gap_chain_mk (chain form)": gb.LAUNCHES["chain"],
                "gap_chain_mk (anchor form)": gb.LAUNCHES["anchor"]}

    def timed(fn, reps=1, warm=True, setup=None):
        """(result, ms per call) over ``reps`` calls, after one warm call
        (the first launch also loads the kernel module); ``setup`` runs
        before every call, outside the timed span."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for rep in range(reps + bool(warm)):
            if setup:
                setup()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            if rep or not warm:
                total += start.elapsed_time(end)
        return out, total / reps

    def max_err(a, b):
        assert a.shape == b.shape, (a.shape, b.shape)
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def bound(nbytes, nops):
        """(ms, which): the least time the card could take for a call
        that must move ``nbytes`` once and do ``nops`` operations."""
        by = nbytes / HBM_BYTES_PER_S * 1e3
        op = nops / OPS_PER_S * 1e3
        return max(by, op), "bytes" if by >= op else "operations"

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    LAYOUTS_OF = {4: ("sector", "bitplane"), 7: ("bitplane",),
                  200: ("bytes",)}

    # ---- 3. LF-walk kernel against its plain version at 2^22 -----------
    def lanes_for(isa, n, nlanes):
        rate = n // nlanes
        pos = np.arange(0, n, rate, dtype=np.int64)
        seg = np.diff(np.r_[pos, n])
        start = (pos + seg) % n          # lane 0 wraps through n-1, ...
        return [torch.from_numpy(a).to(dev) for a in (isa[start], start, seg)]

    n_small, nlanes = 1 << 22, 131072
    for sigma, layouts in LAYOUTS_OF.items():
        rng = np.random.default_rng(args.seed + sigma)
        text = rng.integers(0, sigma, n_small).astype(np.uint8)
        sa, isa, bwt = suffix_array(text, sigma, dev)
        r0, p0, seg = lanes_for(isa, n_small, nlanes)
        t_dev = torch.from_numpy(text).to(dev)
        t_dev[12345] = (t_dev[12345] + 1) % sigma
        for layout in layouts:
            focc = build_focc_host(bwt.astype(np.uint8), sigma, dev, layout)
            checks = {}
            k, k_ms = timed(lambda: lw.lf_walk(focc, r0, 256), reps=5)
            p, p_ms = timed(lambda: lw.lf_walk_plain(focc, r0, 256))
            checks["lf_walk"] = (max_err(k, p), k_ms, p_ms)
            k, k_ms = timed(lambda: lw.verify_walk(focc, t_dev, r0, p0, seg),
                            reps=5)
            p, p_ms = timed(lambda: lw.verify_walk_plain(focc, t_dev, r0, p0,
                                                         seg))
            if int(k.sum()) != 1:
                raise AssertionError("verify_walk found %d mismatches, want "
                                     "1" % int(k.sum()))
            checks["verify_walk"] = (max_err(k, p), k_ms, p_ms)
            (ks, ki), k_ms = timed(lambda: lw.harvest_walk(
                focc, r0, p0, seg, 32, 262144), reps=5)
            (ps, pi), p_ms = timed(lambda: lw.harvest_walk_plain(
                focc, r0, p0, seg, 32, 262144))
            if not (np.array_equal(ks.cpu().numpy(), sa[::32])
                    and np.array_equal(ki.cpu().numpy(), isa[::262144])):
                raise AssertionError("harvest_walk disagrees with the sort")
            checks["harvest_walk"] = (max(max_err(ks, ps), max_err(ki, pi)),
                                      k_ms, p_ms)
            # the select visit: every lane walks to the next of the marked
            # ranks (every 97th position's), SA[start] = SA[hit] + steps
            marks = isa[::97]
            words = np.zeros(n_small // 32 + 1, np.uint32)
            np.bitwise_or.at(words, marks >> 5,
                             np.uint32(1) << (marks & 31).astype(np.uint32))
            bitw = torch.from_numpy(words.view(np.int32)).to(dev)
            (kr, kst), k_ms = timed(lambda: lw.select_walk(focc, bitw, r0,
                                                           300), reps=5)
            (pr_, pst), p_ms = timed(lambda: lw.select_walk_plain(
                focc, bitw, r0, 300))
            if not np.array_equal(
                    (sa[kr.cpu().numpy()] + kst.cpu().numpy()) % n_small,
                    sa[r0.cpu().numpy()]) or int(kst.min()) < 0:
                raise AssertionError("select_walk disagrees with the sort")
            checks["select_walk"] = (max(max_err(kr, pr_), max_err(kst, pst)),
                                     k_ms, p_ms)
            for name, (err, k_ms, p_ms) in checks.items():
                say("kernel %-12s sigma=%-3d %-8s rows n=2^22 lanes=%d: "
                    "max_abs_err %d, kernel %.3f ms, plain %.3f ms"
                    % (name, sigma, focc.LAYOUT, nlanes, err, k_ms, p_ms))
                if err:
                    raise AssertionError("%s disagrees with its plain "
                                         "version" % name)

    # ---- 3b. what the walk's step rate follows: table size and lanes ---
    # kernel only (no plain version: the LF step of any symbol sequence is
    # a bijection, so random symbols walk like a BWT), rank rows inside
    # the 50 MB L2 (n = 2^24: 8 MB) and far past it (n = 2^28: 128 MB)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for lg in (24, 28):
        sym = torch.randint(0, 4, (1 << lg,), device=dev, generator=gen,
                            dtype=torch.uint8)
        foccs = {lay: build_focc_device(sym, 4, lay)
                 for lay in ("sector", "bitplane")}
        del sym
        for lanes in (1 << 15, 1 << 16, 97657, 1 << 17, 1 << 18):
            steps = (1 << 25) // lanes
            r32 = torch.randint(0, 1 << lg, (lanes,), device=dev,
                                generator=gen, dtype=torch.int32)
            l32 = torch.full_like(r32, steps)
            ms = dict.fromkeys(foccs, 0.0)
            for lay in ("sector", "bitplane", "bitplane", "sector"):
                ms[lay] += timed(lambda: lw._launch(foccs[lay], r32, l32),
                                 reps=5)[1] / 2
            say("lf_walk step rate, n=2^%d, %d lanes x %d steps: sector rows "
                "%.3f ms (%.1f G steps/s), bit-plane rows %.3f ms (%.1f G "
                "steps/s) [%s]"
                % (lg, lanes, steps, ms["sector"],
                   lanes * steps / ms["sector"] / 1e6, ms["bitplane"],
                   lanes * steps / ms["bitplane"] / 1e6, smi))
        del foccs

    # ---- 4. gap-chain kernel against its plain version at 2^22 ---------
    def level_lanes(level):
        """(kid, starts, seeds, lens) of an anchored level, as numpy."""
        return (np.concatenate([np.full(sp.T, sp.k) for sp in level.specs]),
                np.concatenate([sp.starts for sp in level.specs]),
                np.concatenate([sp.seeds for sp in level.specs]),
                np.concatenate([sp.lens for sp in level.specs]))

    def mk_args(level, focc, kd, st):
        return (focc, level.text_dev, level.gt_dev, level.c_first,
                level.table, kd, st)

    def level_buffers(level, focc):
        gap = torch.empty(focc.n + 1, dtype=torch.int32, device=dev)
        samp = torch.empty(level._nsamp, dtype=torch.int32, device=dev)

        def clear():
            gap.zero_()
            samp.fill_(-1)

        return gap, samp, clear

    def level_compare(level, foccs, lanes, reps, warm_plain, label, lb=64):
        """``bwt_gap_chain_mk`` against its plain version on the lanes
        (kid, starts, seeds, lens) of ``level`` (a ``BatchedGapRunner``):
        the recording form, then the anchor form over ``lb`` steps from
        each merge's rank 0 and from its top, per rank-row layout in
        ``foccs`` (more than one only for a level of one merge, whose
        rank base is 0 on every layout).  Where ``level`` has computed its
        own histogram and samples on that layout, both are held to them
        too.  Returns {layout: {max_abs_err, ms, plain_ms, bound_ms,
        bound_by, forms, steps, lanes}}, the times summed over the three
        launches."""
        kid, starts, seeds, lens = lanes
        level._ensure_gt(level._caps(kid, starts + lb))
        kd, st, sd, ln = level._lanes(kid, starts, seeds, lens)
        rate = level.sample_rate
        steps = int(lens.sum())
        left = sum(sp.m - sp.s for sp in level.specs)
        a_st = st + lb
        a_ln = torch.full_like(ln, lb)
        bases = np.array([level.specs[k].rbase for k in kid])
        tops = bases + np.array([level.specs[k].gap_size for k in kid])
        out = {}
        for layout, focc in foccs.items():
            say_l = "%s %s rows," % (label, layout)
            args = mk_args(level, focc, kd, st)
            gap, samp, clear = level_buffers(level, focc)
            fk, k_ms = timed(lambda: gb.chain_walk_mk(*args, sd, ln, gap,
                                                      samp, rate),
                             reps=reps, setup=clear)
            if int(gap.sum()) != left:
                raise AssertionError("gap total %d != left blocks %d"
                                     % (int(gap.sum()), left))
            if focc is level.focc and level.gap is not None:
                ref_gap, ref_samp = level.gap, level._samp
            else:
                ref_gap, ref_samp = gap.clone(), samp.clone()
            errs = [max(max_err(gap, ref_gap), max_err(samp, ref_samp))]
            fp, p_ms = timed(lambda: gb.gap_chain_mk_plain(
                *args, sd, ln, gap, samp, rate), warm=warm_plain,
                setup=clear)
            errs.append(max(max_err(fk, fp), max_err(gap, ref_gap),
                            max_err(samp, ref_samp)))
            # each input read once, each output written once
            nb = (nbytes(focc.rows, level.table, level.c_first) + steps
                  + steps // 8 + len(st) * (4 + 8 + 4 + 4 + 4)
                  + 4 * gap.numel() + 4 * samp.numel())
            b_ms, b_by = bound(nb, steps * CHAIN_STEP_OPS[layout])
            forms = {"recording": k_ms}
            kt, pt = k_ms, p_ms
            say("kernel gap_chain_mk %s chain form (%d steps): max_abs_err "
                "%d, kernel %.3f ms (%.2f G steps/s), plain %.3f ms, bound "
                "%.3f ms (%s)" % (say_l, steps, max(errs), k_ms,
                                  steps / k_ms / 1e6, p_ms, b_ms, b_by))
            del ref_gap, ref_samp, gap, samp, fk, fp
            for which, r0s in (("from rank 0", bases),
                               ("from the top", tops)):
                a_sd = torch.from_numpy(gb.u32_bits(r0s)).to(dev)
                a_args = (*mk_args(level, focc, kd, a_st), a_sd, a_ln)
                k, k_ms = timed(lambda: gb.anchor_walk_mk(*a_args),
                                reps=reps)
                p_, p_ms = timed(lambda: gb.gap_chain_mk_plain(*a_args),
                                 warm=warm_plain)
                errs.append(max_err(k, p_))
                ab_ms, _by = bound(
                    nbytes(focc.rows, level.table, level.c_first)
                    + lb * len(st) * 9 // 8 + len(st) * 24,
                    lb * len(st) * CHAIN_STEP_OPS[layout])
                b_ms += ab_ms
                kt, pt = kt + k_ms, pt + p_ms
                forms["anchor " + which] = k_ms
                say("kernel gap_chain_mk %s anchor form %s, %d steps: "
                    "max_abs_err %d, kernel %.3f ms, plain %.3f ms, bound "
                    "%.3f ms" % (say_l, which, lb, errs[-1], k_ms, p_ms,
                                 ab_ms))
            if max(errs):
                raise AssertionError("gap_chain_mk disagrees with its plain "
                                     "version on %s rows" % layout)
            out[layout] = {"max_abs_err": max(errs), "ms": kt,
                           "plain_ms": pt, "bound_ms": b_ms,
                           "bound_by": b_by, "forms": forms, "steps": steps,
                           "lanes": len(st), "merges": len(level.specs)}
        return out

    def one_merge(text_dev, text_host, sigma, s, m, e, r_start, hist, packed,
                  rate, layouts, lane_bucket=1 << 16):
        """A pair merge as a level of one, and its rank rows per layout."""
        bits = bits_for(sigma)
        level = gb.BatchedGapRunner(
            text_dev, text_host, sigma, [(s, m, e, r_start, hist)], [packed],
            bits, lane_bucket=lane_bucket, sample_rate=rate,
            layout=layouts[0])
        foccs = {layouts[0]: level.focc}
        for lay in layouts[1:]:
            foccs[lay] = build_focc_concat([packed], [e - m], sigma, bits,
                                           lay)[0]
        return level, foccs

    for sigma, layouts in LAYOUTS_OF.items():
        rng = np.random.default_rng(args.seed + 40 + sigma)
        n_g, m_g = 1 << 23, 1 << 22
        text = rng.integers(0, sigma, n_g).astype(np.uint8)
        sa, isa, _bwt = suffix_array(text, sigma, dev)
        right = sa[sa >= m_g]                       # rotation order of M
        rbwt = text[(right - 1) % n_g]
        R = np.searchsorted(np.sort(isa[m_g:]), isa)     # R(p) for every p
        level, foccs = one_merge(
            torch.from_numpy(text).to(dev), text, sigma, 0, m_g, n_g,
            int(R[m_g]), np.bincount(text[m_g:], minlength=sigma),
            rows_from_host_bwt(rbwt, sigma, dev), 64, layouts)
        bounds = np.linspace(0, m_g, (1 << 16) + 1).astype(np.int64)
        starts, lens = bounds[1:] - 1, np.diff(bounds)
        level_compare(level, foccs, (np.zeros(len(starts), np.int64), starts,
                                     R[starts + 1], lens), 5, True,
                      "sigma=%-3d right 2^22 ranks, left 2^22, 65536 lanes:"
                      % sigma)
        # and the runner's own anchors and chains give R itself, on every
        # layout
        for focc in foccs.values():
            level.focc = focc
            level.compute()
            view = level.view(0)
            if not (np.array_equal(view.harvest_samples()[1], R[0:m_g:64])
                    and np.array_equal(
                        view.gap.cpu().numpy(),
                        np.bincount(R[:m_g], minlength=n_g - m_g + 1))
                    and np.array_equal(level.specs[0].seeds,
                                       R[level.specs[0].starts + 1])):
                raise AssertionError("gap chain disagrees with the sort")
        del level, foccs, sa, isa, R

    # ---- 5. single-block path -------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    inp = os.path.join(WORK, "chr.bin")
    t0 = time.monotonic()
    text = make_text(args.n, args.seed)
    text.tofile(inp)
    say("input: n=%d ACGT with 1000 mutated repeats, made in %.2f s (host)"
        % (args.n, time.monotonic() - t0))
    bwt_path = inp + ".bwt"
    tools = []

    def run_tool(name, argv, fn=None):
        """One CLI call (or ``fn()``, a library call that returns an exit
        code): (exit code, stdout, {phase: (wall s, device s)}), with its
        wall time and the card's busy time (kernel time sum from the
        profiler); the tool's stderr log is echoed."""
        torch.cuda.synchronize()
        buf, ebuf = io.StringIO(), io.StringIO()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()       # the profiler's set-up and
            try:                        # teardown stay out
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(ebuf):
                    rc = fn() if fn else dispatch(argv)
                torch.cuda.synchronize()
            finally:
                sys.stderr.write(ebuf.getvalue())
            wall = time.monotonic() - t0
        evs = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        busy_us = sum(e.self_device_time_total for e in evs
                      if e.device_type == cuda and not e.is_user_annotation)
        # per engine phase: the device time of the kernels launched inside
        # its span (host-side range) and the span on the card's timeline
        dev_us, span_us = {}, {}
        for e in evs:
            if e.key.startswith(PHASE_PREFIX):
                k = e.key[len(PHASE_PREFIX):]
                d = span_us if e.device_type == cuda else dev_us
                d[k] = d.get(k, 0) + e.device_time_total
        walls = {}
        for line in ebuf.getvalue().splitlines():
            if "phases (wall s): " in line:
                walls = json.loads(line.split("phases (wall s): ", 1)[1])
        phases = {k: (walls.get(k, 0.0), dev_us.get(k, 0) / 1e6,
                      span_us.get(k, 0) / 1e6)
                  for k in sorted(set(walls) | set(dev_us))}
        tools.append((name, wall, busy_us / 1e6))
        out = buf.getvalue()
        say("%s: exit %d, wall %.3f s, device busy %s | %s"
            % (name, rc, wall, "%.3f s" % (busy_us / 1e6) if busy_us
               else "not measured", out.strip().replace("\n", " ")))
        run_tool.log = ebuf.getvalue()
        return rc, out, phases

    path_counts = {}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, _, _ = run_tool("bwtb3m", ["bwtb3m", "inputtype=bytestream",
                                   "device=cuda", inp])
    if rc != 0:
        raise AssertionError("bwtb3m failed")
    rc, out, _ = run_tool("checkbwt", ["checkbwt", "inputtype=bytestream",
                                       "device=cuda", inp, bwt_path])
    if rc != 0 or "gok=1" not in out:
        raise AssertionError("checkbwt did not print gok=1")

    # a copy of the build with one BWT symbol changed must fail
    bad_base = os.path.join(WORK, "bad")
    meta = json.load(open(inp + ".meta"))
    bwt = BwtResult(meta).load_bwt()
    i = len(bwt) // 2
    bwt[i] = ord("C") if bwt[i] != ord("C") else ord("G")
    write_bwt(bad_base + ".bwt", bwt, meta["sigma"])
    del bwt
    for ext in ("preisa", "hist"):
        shutil.copy(meta["files"][ext], bad_base + "." + ext)
    meta["files"] = {"bwt": bad_base + ".bwt", "preisa": bad_base + ".preisa",
                     "hist": bad_base + ".hist"}
    with open(bad_base + ".meta", "w") as f:
        json.dump(meta, f)
    rc, out, _ = run_tool("checkbwt (one symbol changed)",
                          ["checkbwt", "inputtype=bytestream", "device=cuda",
                           inp, bad_base + ".bwt"])
    if rc != 1 or "gok=0" not in out:
        raise AssertionError("checkbwt did not print gok=0 on the corrupted "
                             "copy")

    ref_sa, ref_isa = os.path.join(WORK, "ref.sa"), os.path.join(WORK,
                                                                 "ref.isa")
    shutil.copy(inp + ".sa", ref_sa)
    shutil.copy(inp + ".isa", ref_isa)
    rc, _, _ = run_tool("bwtcomputessa", [
        "bwtcomputessa", "sasamplingrate=32", "isasamplingrate=262144",
        "ref_sa=" + ref_sa, "ref_isa=" + ref_isa, "device=cuda", bwt_path])
    if rc != 0:
        raise AssertionError("bwtcomputessa failed")
    path_counts["single-block path"] = counts()
    peak_single = torch.cuda.max_memory_allocated()
    say("single-block path launches: %s" % path_counts["single-block path"])
    if path_counts["single-block path"]["lf_walk"] < 1:
        raise AssertionError("the single-block path never launched the "
                             "LF-walk kernel")

    # ---- 6. independent SA check ---------------------------------------
    rng = np.random.default_rng(args.seed + 5)
    t_term = np.r_[rng.integers(1, 5, n_small - 1), 0].astype(np.uint8)
    t0 = time.monotonic()
    want = numpy_sa(t_term)
    t_np = time.monotonic() - t0
    sa, _isa, _bwt = suffix_array(t_term, 256, dev)
    if not np.array_equal(sa, want):
        raise AssertionError("doubling SA differs from the numpy SA at "
                             "n=2^22")
    say("SA cross-check at n=2^22 (unique smallest terminator, numpy "
        "lexsort doubling %.2f s on the host): ok" % t_np)

    # ---- 7. LF-walk kernel at the single-block path's shapes -------------
    def lf_compare(bwt_file, raw_text, label,
                   layouts=("sector", "bitplane"),
                   forms=("lf_walk", "verify_walk", "harvest_walk")):
        """Every LF-walk form against its plain version on the seeds and
        segments that checkbwt and bwtcomputessa give it for ``bwt_file``:
        on the rank rows the tools built (sector rows for DNA) and on
        bit-plane rows of the same BWT, the kernel timed in turns (sector,
        bit-plane, bit-plane, sector), for the ``layouts`` and ``forms``
        asked.  Returns {layout: {max_abs_err, ms,
        plain_ms, bound_ms, bound_by, forms}}; ms, plain_ms and bound_ms
        are summed over the forms the tools launch (verify + harvest)."""
        res = BwtResult.load(bwt_file)
        focc, symmap = res.load_focc(dev)
        if focc.LAYOUT != "sector":
            raise AssertionError("the tools' rank rows for DNA are %s rows, "
                                 "not sector rows" % focc.LAYOUT)
        n = focc.n
        foccs = {"sector": focc}
        if "bitplane" in layouts:
            bwt_dev = torch.cat([access(focc, torch.arange(
                a, min(n, a + (1 << 24)), device=dev)).to(torch.uint8)
                for a in range(0, n, 1 << 24)])
            foccs["bitplane"] = build_focc_device(bwt_dev, focc.sigma,
                                                  "bitplane")
            del bwt_dev
        ranks, positions, _rate = res.load_preisa()
        ranks, positions, seg = seed_segments(ranks, positions,
                                              len(raw_text))
        table = np.zeros(256, np.uint8)
        table[symmap] = np.arange(len(symmap))
        t_dev = torch.from_numpy(table[raw_text]).to(dev)
        r0, p0, sl = (torch.from_numpy(a).to(dev)
                      for a in (ranks, positions, seg))
        steps, total = int(seg.max()), int(seg.sum())
        lane_io = len(ranks) * 4

        def runs(f):
            return {
                "lf_walk": (lambda: lw.lf_walk(f, r0, steps),
                            lambda: lw.lf_walk_plain(f, r0, steps),
                            nbytes(f.rows) + 2 * lane_io,
                            len(ranks) * steps),
                "verify_walk": (
                    lambda: lw.verify_walk(f, t_dev, r0, p0, sl),
                    lambda: lw.verify_walk_plain(f, t_dev, r0, p0, sl),
                    nbytes(f.rows, t_dev) + 5 * lane_io, total),
                "harvest_walk": (
                    lambda: torch.cat(lw.harvest_walk(f, r0, p0, sl, 32,
                                                      262144)),
                    lambda: torch.cat(lw.harvest_walk_plain(
                        f, r0, p0, sl, 32, 262144)),
                    nbytes(f.rows) + 4 * lane_io
                    + 4 * (-(-n // 32) - (-n // 262144)), total),
            }

        out = {lay: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0, "bound_by": "bytes", "forms": {}}
               for lay in foccs}
        for name in forms:
            k_ms = {lay: 0.0 for lay in foccs}
            for lay in ("sector", "bitplane", "bitplane", "sector"):
                if lay not in foccs:
                    continue
                k, ms = timed(runs(foccs[lay])[name][0], reps=3)
                k_ms[lay] += ms / 2
            for lay, f in foccs.items():
                kern, plain, nb, nsteps = runs(f)[name]
                k = kern()
                p, p_ms = timed(plain, warm=False)
                err = max_err(k, p)
                b_ms, b_by = bound(nb, nsteps * LF_STEP_OPS[lay])
                say("kernel %-12s %s, %s rows (n=%d, %d lanes, %d steps "
                    "max): max_abs_err %d, kernel %.3f ms, plain %.3f ms, "
                    "bound %.3f ms (%s)"
                    % (name, label, lay, n, len(ranks), steps, err,
                       k_ms[lay], p_ms, b_ms, b_by))
                if err:
                    raise AssertionError("%s disagrees with its plain "
                                         "version on the %s, %s rows"
                                         % (name, label, lay))
                o = out[lay]
                o["forms"][name] = k_ms[lay]
                if name != "lf_walk":       # the forms the tools launch
                    o["ms"] += k_ms[lay]
                    o["plain_ms"] += p_ms
                    o["bound_ms"] += b_ms
                    o["bound_by"] = b_by
        for lay, o in out.items():
            say("kernel lf_walk, the tools' forms (verify_walk + "
                "harvest_walk) on the %s, %s rows: kernel %.3f ms, plain "
                "%.3f ms, bound %.3f ms"
                % (label, lay, o["ms"], o["plain_ms"], o["bound_ms"]))
        return out

    lf_single = lf_compare(bwt_path, text, "single-block path")
    del text
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # ---- 8. merge engine against the doubling engine at 2^24 + 43 ------
    n8 = 16_777_259
    inp8 = os.path.join(WORK, "mid.bin")
    make_text(n8, args.seed + 8).tofile(inp8)
    outs = {}
    for eng, extra in (("merge", ["mem=67108864"]), ("doubling", [])):
        outs[eng] = os.path.join(WORK, "mid_%s.bwt" % eng)
        rc, _, _ = run_tool("bwtb3m engine=%s n=%d" % (eng, n8), [
            "bwtb3m", "inputtype=bytestream", "bwtonly=1", "device=cuda",
            "engine=" + eng, "outputfilename=" + outs[eng], *extra, inp8])
        if rc != 0:
            raise AssertionError("bwtb3m engine=%s failed" % eng)
    for ext in ("bwt", "hist", "preisa"):
        a, b = (open(outs[e][:-4] + "." + ext, "rb").read()
                for e in ("merge", "doubling"))
        if a != b:
            raise AssertionError(".%s of engine=merge differs from "
                                 "engine=doubling" % ext)
    say("engine=merge (mem=67108864: 5 blocks, 3 levels) == engine=doubling "
        "at n=%d: .bwt .hist .preisa byte-identical" % n8)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # ---- 9. the merge path at 400M --------------------------------------
    nm = args.merge_n
    inpm = os.path.join(WORK, "big.bin")
    t0 = time.monotonic()
    text = make_text(nm, args.seed + 9)
    text.tofile(inpm)
    say("input: n=%d ACGT with 1000 mutated repeats, made in %.2f s (host)"
        % (nm, time.monotonic() - t0))
    bwtm = inpm + ".bwt"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, _, merge_phases = run_tool("bwtb3m (merge path)", [
        "bwtb3m", "inputtype=bytestream", "bwtonly=1", "device=cuda",
        "mem=%d" % args.merge_mem, inpm])
    if rc != 0:
        raise AssertionError("bwtb3m failed on the merge path")
    if "chains" not in merge_phases:
        raise AssertionError("the %d-symbol build did not take the merge "
                             "engine" % nm)
    rc, out, _ = run_tool("checkbwt (merge path)", [
        "checkbwt", "inputtype=bytestream", "device=cuda", inpm, bwtm])
    if rc != 0 or "gok=1" not in out:
        raise AssertionError("checkbwt did not print gok=1 on the merge "
                             "build")
    rc, _, _ = run_tool("bwtcomputessa (merge path)", [
        "bwtcomputessa", "sasamplingrate=32", "isasamplingrate=262144",
        "device=cuda", bwtm])
    if rc != 0:
        raise AssertionError("bwtcomputessa failed on the merge build")
    path_counts["merge path"] = counts()
    peak_merge = torch.cuda.max_memory_allocated()
    say("merge path launches: %s" % path_counts["merge path"])
    if min(path_counts["merge path"][k] for k in LIBRARIES) < 1:
        raise AssertionError("the merge path did not launch every kernel")
    resm = BwtResult.load(bwtm)
    pr, pp, prate = resm.load_preisa()
    _r, sa_s = load_sampled_array(inpm + ".sa")
    _r, isa_s = load_sampled_array(inpm + ".isa")
    on_isa = pp % 262144 == 0
    on_sa = pr % 32 == 0
    if not (np.array_equal(isa_s[pp[on_isa] // 262144], pr[on_isa])
            and np.array_equal(sa_s[pr[on_sa] // 32], pp[on_sa])
            and on_isa.sum() == len(isa_s)):
        raise AssertionError("bwtcomputessa's .sa/.isa disagree with the "
                             "merge build's .preisa")
    say("bwtcomputessa .sa/.isa agree with the merge build's .preisa: %d "
        "ISA samples, %d SA samples at preisa pairs"
        % (int(on_isa.sum()), int(on_sa.sum())))
    # the LF walk at the merge path's shapes (the rank rows come from the
    # memo that checkbwt and bwtcomputessa filled)
    lf_merge = lf_compare(bwtm, text, "merge path")

    # ---- 10. gap-chain kernel at the root merge's shapes -----------------
    # with three blocks the root merges [0, m) with the carried last
    # block [m, n): sort that block again, as the engine did
    opts = BwtOptions(input_path=inpm, mem=args.merge_mem, device="cuda")
    blocks = merge_scaled._plan_blocks_fixed(nm, opts.max_block_symbols)
    if len(blocks) != 3:
        raise AssertionError("expected 3 blocks, planned %d" % len(blocks))
    s_r, (m_r, e_r) = 0, blocks[-1]
    table = np.zeros(256, np.uint8)
    table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dense = table[text]           # the engine's alphabet compaction
    del text
    ctx = merge_scaled._Ctx(dense, 4, prate, opts, None, 1 << 16, dev,
                            Phases(dev))
    right = merge_scaled._sort_block(ctx, m_r, e_r)
    level, foccs = one_merge(ctx.text_dev, ctx.text, 4, s_r, m_r, e_r,
                             right.r_start, right.hist, right.packed, prate,
                             ("sector", "bitplane"))
    level.anchor_all()
    lanes = level_lanes(level)
    kid, starts, seeds, lens = lanes
    root = "root merge (left %d, right %d ranks" % (m_r - s_r, e_r - m_r)
    gc = level_compare(level, foccs, lanes, 3, False,
                       "%s, %d lanes):" % (root, len(starts)))

    # the chain's own two questions, kernel only.  (a) the anchor form
    # over the root's lanes at their full length: the recording walk
    # without the histogram atomic and the sample write
    kd, st, sd, ln = level._lanes(*lanes)
    # one histogram for both layouts: the bit-plane rows' rank space (a
    # grid of 256) covers the sector rows' (a grid of 64)
    gap, samp, clear = level_buffers(level, foccs["bitplane"])
    turns = ("sector", "bitplane", "bitplane", "sector")
    full = {"recording": dict.fromkeys(foccs, 0.0),
            "anchor": dict.fromkeys(foccs, 0.0)}
    for lay in turns:
        a_ = mk_args(level, foccs[lay], kd, st)
        fin_r, t_ms = timed(lambda: gb.chain_walk_mk(*a_, sd, ln, gap, samp,
                                                     prate), reps=3,
                            setup=clear)
        full["recording"][lay] += t_ms / 2
        fin_a, t_ms = timed(lambda: gb.anchor_walk_mk(*a_, sd, ln), reps=3)
        full["anchor"][lay] += t_ms / 2
        if not torch.equal(fin_r, fin_a):
            raise AssertionError("the anchor form's final ranks differ from "
                                 "the recording form's")
    gap_ref = gap.clone()
    for lay in foccs:
        say("gap_chain_mk %s, %d lanes x %d steps), %s rows: recording form "
            "%.3f ms, anchor form at full length %.3f ms, so histogram "
            "atomic + sample write %.3f ms [%s]"
            % (root, len(starts), int(lens.max()), lay,
               full["recording"][lay], full["anchor"][lay],
               full["recording"][lay] - full["anchor"][lay], smi))

    # (b) the recording form at 2^15 to 2^18 lanes: the outputs do not
    # depend on the lane split
    by_lanes = {}
    for lg in (15, 16, 17, 18):
        level.lane_bucket = 1 << lg
        level.focc = foccs["sector"]
        level.anchor_all()
        kd_l, st_l, sd_l, ln_l = level._lanes(*level_lanes(level))
        level._ensure_gt([int(st_l.max()) + 1])
        by_lanes[lg] = dict.fromkeys(foccs, 0.0)
        for lay in turns:
            a_ = mk_args(level, foccs[lay], kd_l, st_l)
            _f, t_ms = timed(lambda: gb.chain_walk_mk(
                *a_, sd_l, ln_l, gap, samp, prate), reps=3, setup=clear)
            by_lanes[lg][lay] += t_ms / 2
            if not torch.equal(gap, gap_ref):
                raise AssertionError("the histogram depends on the lane "
                                     "split (%d lanes)" % len(st_l))
        say("gap_chain_mk %s), recording form at %d lanes x %d steps: sector "
            "rows %.3f ms, bit-plane rows %.3f ms [%s]"
            % (root, len(st_l), int(ln_l.max()), by_lanes[lg]["sector"],
               by_lanes[lg]["bitplane"], smi))

    # the bytes the L2 fetches from device memory per miss: the default,
    # 32, and the default again (set back whatever happens)
    l2 = _build.load("lf_walk").bwt_l2_fetch_granularity
    g0 = l2(0)
    try:
        for g in (g0, 32, g0):
            got = l2(g)
            a_s = mk_args(level, foccs["sector"], kd, st)
            a_b = mk_args(level, foccs["bitplane"], kd, st)
            _f, r_ms = timed(lambda: gb.chain_walk_mk(
                *a_s, sd, ln, gap, samp, prate), reps=3, setup=clear)
            _f, a_ms = timed(lambda: gb.anchor_walk_mk(*a_s, sd, ln), reps=3)
            _f, b_ms = timed(lambda: gb.anchor_walk_mk(*a_b, sd, ln), reps=3)
            say("L2 fetch granularity asked %d, reads back %d: root chain "
                "recording form %.3f ms and anchor form at full length "
                "%.3f ms on sector rows, anchor form %.3f ms on bit-plane "
                "rows [%s]" % (g, got, r_ms, a_ms, b_ms, smi))
    finally:
        l2(g0)
    del ctx, level, foccs, right, dense, gap, samp, gap_ref

    # ---- 11. the genome path ---------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ng = args.genome_n
    wide = ng >= 1 << 31      # checkbwt and the SA tools need wide lanes
    inpg = os.path.join(WORK, "genome.bin")
    t0 = time.monotonic()
    text = make_text(ng, args.seed + 11)
    text.tofile(inpg)
    say("input: n=%d ACGT with 1000 mutated repeats, made in %.2f s (host)"
        % (ng, time.monotonic() - t0))
    bwtg = inpg + ".bwt"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, _, genome_phases = run_tool("bwtb3m (genome path)", [
        "bwtb3m", "inputtype=bytestream", "bwtonly=%d" % wide,
        "sasamplingrate=32", "isasamplingrate=262144", "device=cuda",
        "mem=%d" % args.genome_mem, "hostmem=%d" % args.genome_hostmem,
        inpg])
    if rc != 0:
        raise AssertionError("bwtb3m failed on the genome path")
    build_log = run_tool.log
    levels = [ln for ln in build_log.splitlines() if "batched level: " in ln]
    for ln in build_log.splitlines():
        if "batched level: " in ln or "pair merge: " in ln:
            say("genome build, %s [%s]" % (ln.split("] ", 1)[-1], smi))
    optsg = BwtOptions(input_path=inpg, mem=args.genome_mem, device="cuda")
    blocks = merge_scaled._plan_blocks_fixed(ng, optsg.max_block_symbols)
    nblocks = len(blocks)
    want_levels, depth, k = 0, 0, nblocks
    while k > 1:
        want_levels += k // 2 >= 2
        depth += 1               # one chain launch per level of the tree
        k -= k // 2
    if len(levels) != want_levels or gb.LAUNCHES["chain"] != depth:
        raise AssertionError("%d blocks: expected %d batched levels of %d, "
                             "the build ran %d (%d launches of the chain "
                             "form)" % (nblocks, want_levels, depth,
                                        len(levels), gb.LAUNCHES["chain"]))
    if not wide:
        if "hand-off" not in build_log:
            raise AssertionError("the build's SA/ISA walk did not take its "
                                 "rank rows from the hand-off")
        rc, out, _ = run_tool("checkbwt (genome path, in the build's "
                              "process)", ["checkbwt", "inputtype=bytestream",
                                           "device=cuda", inpg, bwtg])
        if rc != 0 or "gok=1" not in out or "decode" in run_tool.log:
            raise AssertionError("checkbwt through the hand-off did not "
                                 "print gok=1, or decoded the file")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "bwtb3m_tpu_torch", "checkbwt",
             "inputtype=bytestream", "device=cuda", inpg, bwtg], cwd=REPO,
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr)
        say("checkbwt (genome path, fresh process, from .bwt): exit %d, "
            "wall %.3f s with the interpreter's start | %s [%s]"
            % (proc.returncode, time.monotonic() - t0, proc.stdout.strip(),
               smi))
        if proc.returncode != 0 or "gok=1" not in proc.stdout \
                or "decode" not in proc.stderr:
            raise AssertionError("checkbwt in a fresh process did not print "
                                 "gok=1 from the file")
        isa_build = open(inpg + ".isa", "rb").read()
        rc, _, _ = run_tool("hwtPreIsaToIsa (genome path)", [
            "hwtPreIsaToIsa", "isasamplingrate=262144", "device=cuda", bwtg])
        if rc != 0 or open(inpg + ".isa", "rb").read() != isa_build:
            raise AssertionError("hwtPreIsaToIsa's .isa differs from the "
                                 "build's")
        # select_ssa of 2^20 ranks that the .sa samples name
        _r, sa_s = load_sampled_array(inpg + ".sa")
        rng = np.random.default_rng(args.seed + 12)
        want_ranks = 32 * rng.integers(0, len(sa_s), 1 << 20)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = select_ssa(bwtg, want_ranks, device=dev)
        t_sel = time.monotonic() - t0
        if not np.array_equal(got, sa_s[want_ranks // 32]):
            raise AssertionError("select_ssa disagrees with the .sa samples")
        say("select_ssa: 2^20 ranks agree with the .sa samples they name, "
            "%.3f s wall [%s]" % (t_sel, smi))
    peak_genome = torch.cuda.max_memory_allocated()
    path_counts["genome path"] = counts()
    say("genome path launches: %s" % path_counts["genome path"])
    need = ("gap_chain", "gap_chain_mk") if wide else tuple(KERNELS)
    if min(path_counts["genome path"][k] for k in need) < 1:
        raise AssertionError("the genome path did not launch every kernel")

    # the kernels the tools ran on the genome build, against their plain
    # versions at the shapes the tools gave them (the rank rows come from
    # the memo the hand-off filled): the select visit on all of
    # select_ssa's lanes, the verify and harvest walks on checkbwt's and
    # the SA/ISA walk's lanes
    gsel = lf_genome = None
    if not wide:
        focc, _symmap = BwtResult.load(bwtg).load_focc(dev)
        pr_ranks, _pp, prate_g = BwtResult.load(bwtg).load_preisa()
        words = np.zeros(ng // 32 + 1, np.uint32)
        np.bitwise_or.at(words, pr_ranks >> 5,
                         np.uint32(1) << (pr_ranks & 31).astype(np.uint32))
        bitw = torch.from_numpy(words.view(np.int32)).to(dev)
        r_all = torch.from_numpy(want_ranks).to(dev)
        cap = 2 * (int(prate_g) + 512)
        (kr, ks_), sel_ms = timed(lambda: lw.select_walk(focc, bitw, r_all,
                                                         cap), reps=3)
        sel_steps = int(ks_.sum())
        (pr_, ps_), sel_plain_ms = timed(lambda: lw.select_walk_plain(
            focc, bitw, r_all, cap), warm=False)
        sel_err = max(max_err(kr, pr_), max_err(ks_, ps_))
        # each step reads its row's sector and a bitmap word; the data
        # decide the steps
        sel_bound, sel_by = bound(
            nbytes(focc.rows, bitw) + len(r_all) * 16,
            (sel_steps + len(r_all)) * (LF_STEP_OPS["sector"] + 5))
        say("kernel lf_walk select visit, genome path (n=%d, %d lanes, %d "
            "steps, %d at most): max_abs_err %d, kernel %.3f ms (%.2f G "
            "steps/s), plain %.3f ms, bound %.3f ms (%s) [%s]"
            % (ng, len(r_all), sel_steps, int(ks_.max()), sel_err, sel_ms,
               sel_steps / sel_ms / 1e6, sel_plain_ms, sel_bound, sel_by,
               smi))
        if sel_err or int(ks_.min()) < 0:
            raise AssertionError("the select visit disagrees with its plain "
                                 "version")
        gsel = {"sector": {"max_abs_err": sel_err, "ms": sel_ms,
                           "plain_ms": sel_plain_ms, "lanes": len(r_all),
                           "steps": sel_steps, "bound_ms": sel_bound,
                           "bound_by": sel_by, "forms": {"select": sel_ms}}}
        del focc, bitw, kr, ks_, pr_, ps_, r_all
        lf_genome = lf_compare(bwtg, text, "genome path", ("sector",),
                               ("verify_walk", "harvest_walk"))

    pair_phases = {}
    if not wide:
        # the same build pair by pair, through the library's entry point:
        # the same files, and check_bwt of the result it returns takes
        # the build's device symbols (the hand-off, no decode)
        outp = os.path.join(WORK, "pairs.bwt")
        argv = ["bwtb3m", "inputtype=bytestream", "bwtonly=1",
                "batchmerges=0", "device=cuda", "mem=%d" % args.genome_mem,
                "hostmem=%d" % args.genome_hostmem,
                "outputfilename=" + outp, inpg]
        built = []

        def build_pairs():
            built.append(compute_bwt(BwtOptions.from_arginfo(
                ArgInfo(argv[1:], progname="bwtb3m"))))
            return 0

        rc, _, pair_phases = run_tool("bwtb3m batchmerges=0 (genome path, "
                                      "compute_bwt)", argv, fn=build_pairs)
        if rc != 0 or "batched level" in run_tool.log:
            raise AssertionError("bwtb3m batchmerges=0 failed or batched")
        for ln in run_tool.log.splitlines():
            if "pair merge: " in ln:
                say("genome build batchmerges=0, %s [%s]"
                    % (ln.split("] ", 1)[-1], smi))
        for ext in ("bwt", "hist", "preisa"):
            if open(inpg + "." + ext, "rb").read() != \
                    open(outp[:-4] + "." + ext, "rb").read():
                raise AssertionError(".%s of batchmerges=0 differs from "
                                     "batchmerges=1" % ext)
        say("batchmerges=1 == batchmerges=0 at n=%d: .bwt .hist .preisa "
            "byte-identical" % ng)
        rc, _, _ = run_tool(
            "check_bwt of that build's result (hand-off)", [],
            fn=lambda: 0 if check_bwt(built[0], text, device="cuda",
                                      log=VerboseLog(1)) else 1)
        if rc != 0 or "hand-off" not in run_tool.log \
                or "decode" in run_tool.log:
            raise AssertionError("check_bwt of the build's own result "
                                 "failed, or did not take the hand-off")
        del built[:]

    gmk = None
    if not wide:
        # bwt_gap_chain_mk against its plain version at every shape the
        # genome build gives it: the build once more through the engine,
        # where every level's runner, right after its own anchors and
        # chains, has its lanes replayed through the kernel and the plain
        # version; the peak device memory of every block sort and level
        # is held to the figures the engine's gates plan with
        optsg = BwtOptions(input_path=inpg, mem=args.genome_mem,
                           device="cuda", checkpoint=False,
                           output_filename=os.path.join(WORK, "replay.bwt"))
        table = np.zeros(256, np.uint8)
        table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
        dense = table[text]
        del text
        prate_g = BwtResult.load(bwtg).load_preisa()[2]
        replay, mem = [], {"peak": 0, "sorts": [], "levels": []}
        orig_compute = gb.BatchedGapRunner.compute
        orig_pairs = merge_scaled._merge_pairs
        orig_sort = merge_scaled._sort_block

        def used(base):
            return max(mem["peak"],
                       torch.cuda.max_memory_allocated()) - base

        def fresh_peak():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem["peak"] = 0
            return torch.cuda.memory_allocated()

        def spy_compute(self, *a, **k):
            orig_compute(self, *a, **k)
            mem["peak"] = used(0)
            rec = level_compare(
                self, {"sector": self.focc}, level_lanes(self), 3, False,
                "genome build, level of %d merge(s), %d ranks:"
                % (len(self.specs), self.focc.n))["sector"]
            rec["in_build_recording_ms"] = self.chain_ms
            replay.append(rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()   # the replay's buffers

        def spy_pairs(ctx, pairs):
            base = fresh_peak()
            out = orig_pairs(ctx, pairs)
            mem["levels"].append((len(pairs), used(base),
                                  merge_scaled.level_bytes_estimate(
                                      pairs, ctx.sigma, ctx.bits)))
            return out

        def spy_sort(ctx, s, e):
            base = fresh_peak()
            reg = orig_sort(ctx, s, e)
            mem["sorts"].append((e - s, used(base)))
            return reg

        gb.BatchedGapRunner.compute = spy_compute
        merge_scaled._merge_pairs = spy_pairs
        merge_scaled._sort_block = spy_sort
        t0 = time.monotonic()
        try:
            _bwt, spos, srank, _hist = merge_scaled.blockwise_bwt_scaled(
                dense, 4, optsg, VerboseLog(0), sample_rate=prate_g,
                device=dev)
        finally:
            gb.BatchedGapRunner.compute = orig_compute
            merge_scaled._merge_pairs = orig_pairs
            merge_scaled._sort_block = orig_sort
        del _bwt, dense
        pr_ranks, pr_pos, _rate = BwtResult.load(bwtg).load_preisa()
        if not (np.array_equal(spos, pr_pos)
                and np.array_equal(srank, pr_ranks)):
            raise AssertionError("the replayed build's samples differ from "
                                 "the genome build's .preisa")
        say("genome build replayed with every level against the plain "
            "version: %d levels (%s merges), %.2f s, samples equal the "
            "build's .preisa"
            % (len(replay), " ".join(str(r["merges"]) for r in replay),
               time.monotonic() - t0))
        if [r["merges"] for r in replay][:want_levels] != [
                int(ln.split("batched level: ")[1].split()[0])
                for ln in levels]:
            raise AssertionError("the replay's levels are not the build's")
        la_cap = max(1024, optsg.large_lcp_thres)
        for blen, peak in mem["sorts"]:
            lo = merge_scaled.SORT_BYTES_PER_SYMBOL * (blen + 1024)
            hi = merge_scaled.SORT_BYTES_PER_SYMBOL * (blen + la_cap)
            say("block sort of %d symbols: peak %d bytes (%.2f per window "
                "symbol at the first lookahead), the gate plans %d [%s]"
                % (blen, peak, peak / (blen + 1024), lo, smi))
            if peak > hi or lo > 1.3 * peak:
                raise AssertionError("SORT_BYTES_PER_SYMBOL is off the "
                                     "measured peak of a block sort")
        for npairs, peak, est in mem["levels"]:
            say("level of %d merge(s): peak %d bytes beyond the text and its "
                "regions, level_bytes_estimate %d (%.2f x) [%s]"
                % (npairs, peak, est, est / peak, smi))
            if peak > est or est > 1.5 * peak:
                raise AssertionError("level_bytes_estimate is off the "
                                     "measured peak of a level")
        gmk = {"sector": dict(replay[0], levels=replay)}

    # ---- 12. report -----------------------------------------------------
    for name, wall, busy in tools:
        say("tool %-36s wall %.3f s, device busy %.3f s [%s]"
            % (name, wall, busy, smi))
    for name, (wall, dev_s, span_s) in sorted(merge_phases.items(),
                                              key=lambda kv: -kv[1][0]):
        say("merge build phase %-18s wall %.3f s, device busy %s, device "
            "span %s [%s]" % (name, wall, "%.3f s" % dev_s if dev_s
                              else "not measured", "%.3f s" % span_s
                              if span_s else "not measured", smi))
    for name in sorted(set(genome_phases) | set(pair_phases),
                       key=lambda k: -genome_phases.get(k, (0,))[0]):
        say("genome build phase %-18s batchmerges=1: wall %s, device busy "
            "%s | batchmerges=0 (bwtonly=1): wall %s, device busy %s [%s]"
            % ((name,) + tuple(
                "%.3f s" % ph[name][i] if name in ph and ph[name][i]
                else "not measured"
                for ph in (genome_phases, pair_phases) for i in (0, 1))
               + (smi,)))
    say("peak device memory: single-block path %.3f GiB, merge path %.3f "
        "GiB, genome path (build, checkbwt and the SA tools) %.3f GiB [%s]"
        % (peak_single / 2 ** 30, peak_merge / 2 ** 30,
           peak_genome / 2 ** 30, smi))
    shutil.rmtree(WORK, ignore_errors=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    if loaded:
        raise AssertionError("JAX or the JAX package was imported: %s"
                             % loaded)
    kernels = []
    for name, per_layout, extra in (
            ("lf_walk", lf_merge,
             {"layouts_single_block_path": lf_single,
              "layouts_genome_path": lf_genome}),
            ("gap_chain", gc,
             {"entry": "bwt_gap_chain_mk, one merge per launch",
              "root_full_length_ms": full,
              "root_recording_ms_by_log2_lanes": by_lanes}),
            ("gap_chain_mk", gmk,
             {"entry": "bwt_gap_chain_mk, the genome build's levels"}),
            ("lf_walk_select", gsel, {})):
        if per_layout is None:            # a text of 2^31 symbols or more
            continue
        main = per_layout["sector"]       # the layout the path ran
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": path_counts[ROW_PATH[name]][name],
            "shapes_of": ROW_PATH[name],
            "launches_by_path": {p: c[name]
                                 for p, c in path_counts.items()},
            "max_abs_err": max(
                v["max_abs_err"]
                for group in (per_layout, lf_single, lf_genome or {})
                for v in group.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "layout": "sector", "layouts": per_layout,
            **extra})
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
