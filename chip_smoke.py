#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``bwtb3m_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--n 100000003] [--merge-n 400000009]

Phases, in order; any failure exits non-zero and no result line is
printed:

1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
   and the port's native host library (g++), which must have built;
2. build both kernels from ``bwtb3m_tpu_torch/csrc`` (one nvcc each, in
   parallel): the LF walk and the gap chain;
3. the LF-walk kernel through each of its entry points (final rank,
   verify visit, harvest visit) against its plain PyTorch version on the
   card, bit-exact, at n = 2^22 with 131,072 lanes, on every rank-row
   layout: sector and bit-plane rows (sigma 4), bit-plane rows (sigma 7)
   and byte rows (sigma 200); then, kernel only, the walk's step rate
   on sector and bit-plane rows of 2^24 and 2^28 random symbols at 2^15
   to 2^18 lanes (rank rows inside and far past the L2);
4. the gap-chain kernel (recording form and both anchor bounds) against
   its plain version, bit-exact: a right region of 2^22 ranks, a left
   block of 2^22 symbols, 65,536 lanes, on the same four layouts;
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
11. launch counts per path (> 0), kernel times against plain versions
    and bounds, per-phase wall and device time, peak device memory.

The last three lines are the nvidia-smi line, a JSON object of the
kernels, and ``{"ok": true, "device": {...}}``.  A kernel's ``ms``,
``plain_ms`` and ``bound_ms`` there are from the merge path's shapes
(the 400M build's walks; the root merge's chains and anchors) on the
layout that path runs; ``layouts`` has the same numbers per layout.
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
    "gap_chain": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                  "bwtb3m_tpu/ops/gapdev.py:141"),
}
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
    from bwtb3m_tpu_torch.engine.merge_scaled import (
        _Ctx, _plan_blocks_fixed, _sort_block, anchored_lanes)
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.engine.result import BwtResult, write_bwt
    from bwtb3m_tpu_torch.engine.ssa import load_sampled_array, seed_segments
    from bwtb3m_tpu_torch.ops import _build
    from bwtb3m_tpu_torch.ops import gapdev as gd
    from bwtb3m_tpu_torch.ops import lf_walk as lw
    from bwtb3m_tpu_torch.ops.doubling import suffix_array
    from bwtb3m_tpu_torch.ops.focc import access
    from bwtb3m_tpu_torch.ops.focc_build import (build_focc_device,
                                                 build_focc_from_packed,
                                                 build_focc_host)
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
    for name in KERNELS:
        _build.load(name)

    def reset_counts():
        lw.reset_launch_counts()
        gd.reset_launch_counts()

    def counts():
        return {"lf_walk": lw.lf_walk.launches,
                "gap_chain": gd.LAUNCHES["chain"] + gd.LAUNCHES["anchor"],
                "gap_chain (chain form)": gd.LAUNCHES["chain"],
                "gap_chain (anchor form)": gd.LAUNCHES["anchor"]}

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
    def chain_inputs(runner, starts, seeds, lens):
        runner.ensure_gt(int((starts + 64).max()) + 1)
        st, sd, ln = runner._lanes(starts, seeds, lens)
        rate = runner.sample_rate
        p0 = runner.s + (-runner.s) % rate
        gap = torch.empty(runner.gap_size + 1, dtype=torch.int32, device=dev)
        samp = torch.empty(len(range(p0, runner.m, rate)), dtype=torch.int32,
                           device=dev)

        def clear():
            gap.zero_()
            samp.fill_(-1)

        def args_of(focc, st_=st):
            return (focc, runner.text_dev, runner.gt_dev, runner.lo0,
                    runner.c_first, runner.consts, st_)

        return st, sd, ln, gap, samp, p0, rate, clear, args_of

    def chain_bound(runner, focc, st, ln, recording):
        """Bound of one launch: rows, the text and gt bytes walked, lane
        arrays in and out, and for the recording form the histogram and
        the samples written."""
        steps = int(ln.sum())
        nb = (nbytes(focc.rows) + steps + steps // 8
              + len(st) * (8 + 4 + 4 + 4))
        if recording:
            nb += 4 * (runner.gap_size + 1) + 4 * (steps // runner.sample_rate)
        return bound(nb, steps * CHAIN_STEP_OPS[focc.LAYOUT])

    def chain_compare(runner, foccs, starts, seeds, lens, reps, warm_plain,
                      label):
        """Recording form and both anchor bounds (lookback 64), per rank-
        row layout in ``foccs``: kernel against plain version on the same
        inputs.  Returns {layout: {max_abs_err, ms, plain_ms, bound_ms,
        bound_by, forms}}, the times summed over the three launches."""
        st, sd, ln, gap, samp, p0, rate, clear, args_of = chain_inputs(
            runner, starts, seeds, lens)
        a_st = torch.from_numpy(starts + 64).to(dev)
        a_ln = torch.full_like(ln, 64)
        out = {}
        for layout, focc in foccs.items():
            say_l = "%s %s rows," % (label, layout)
            res = []
            for fn, reps_, warm in ((gd.chain_walk, reps, True),
                                    (gd.gap_chain_plain, 1, warm_plain)):
                final, ms = timed(lambda: fn(*args_of(focc), sd, ln, gap,
                                             samp, p0, rate),
                                  reps=reps_, warm=warm, setup=clear)
                res.append((final.clone(), gap.clone(), samp.clone(), ms))
            (fk, gk, sk, k_ms), (fp, gpl, sp, p_ms) = res
            if int(gk.sum()) != runner.m - runner.s:
                raise AssertionError("gap total %d != left block %d"
                                     % (int(gk.sum()), runner.m - runner.s))
            errs = [max(max_err(fk, fp), max_err(gk, gpl), max_err(sk, sp))]
            b_ms, b_by = chain_bound(runner, focc, st, ln, True)
            forms = {"recording": k_ms}
            kt, pt = k_ms, p_ms
            say("kernel gap_chain   %s chain form: max_abs_err %d, kernel "
                "%.3f ms, plain %.3f ms, bound %.3f ms (%s)"
                % (say_l, errs[-1], k_ms, p_ms, b_ms, b_by))
            del res, fk, gk, sk, fp, gpl, sp
            for r0 in (0, runner.gap_size):
                a_sd = torch.full_like(sd, r0)
                a_args = args_of(focc, a_st)
                k, k_ms = timed(lambda: gd.anchor_walk(*a_args, a_sd, a_ln),
                                reps=reps)
                p, p_ms = timed(lambda: gd.gap_chain_plain(*a_args, a_sd,
                                                           a_ln),
                                warm=warm_plain)
                errs.append(max_err(k, p))
                kt, pt = kt + k_ms, pt + p_ms
                ab_ms, ab_by = chain_bound(runner, focc, a_st, a_ln, False)
                b_ms += ab_ms
                forms["anchor from %d" % r0] = k_ms
                say("kernel gap_chain   %s anchor form from %d: max_abs_err "
                    "%d, kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)"
                    % (say_l, r0, errs[-1], k_ms, p_ms, ab_ms, ab_by))
            if max(errs):
                raise AssertionError("gap_chain disagrees with its plain "
                                     "version on %s rows" % layout)
            out[layout] = {"max_abs_err": max(errs), "ms": kt,
                           "plain_ms": pt, "bound_ms": b_ms,
                           "bound_by": b_by, "forms": forms}
        return out

    for sigma, layouts in LAYOUTS_OF.items():
        rng = np.random.default_rng(args.seed + 40 + sigma)
        n_g, m_g = 1 << 23, 1 << 22
        text = rng.integers(0, sigma, n_g).astype(np.uint8)
        sa, isa, _bwt = suffix_array(text, sigma, dev)
        right = sa[sa >= m_g]                       # rotation order of M
        rbwt = text[(right - 1) % n_g]
        foccs = {lay: build_focc_host(rbwt, sigma, dev, lay)
                 for lay in layouts}
        R = np.searchsorted(np.sort(isa[m_g:]), isa)     # R(p) for every p
        runner = gd.GapRunner(
            foccs[layouts[0]], torch.from_numpy(text).to(dev), text, 0, m_g,
            n_g, int(R[m_g]), np.bincount(text[m_g:], minlength=sigma),
            sample_rate=64)
        bounds = np.linspace(0, m_g, (1 << 16) + 1).astype(np.int64)
        starts, lens = bounds[1:] - 1, np.diff(bounds)
        chain_compare(runner, foccs, starts, R[starts + 1], lens, 5, True,
                      "sigma=%-3d right 2^22 ranks, left 2^22, 65536 lanes:"
                      % sigma)
        # and the harvested samples are R itself, on every layout
        for focc in foccs.values():
            runner.focc = focc
            runner.run_chains(starts, R[starts + 1], lens)
            if not (np.array_equal(runner.harvest_samples()[1], R[0:m_g:64])
                    and np.array_equal(
                        runner.gap.cpu().numpy(),
                        np.bincount(R[:m_g], minlength=runner.gap_size + 1))):
                raise AssertionError("gap chain disagrees with the sort")
        del runner, foccs, sa, isa, R

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

    def run_tool(name, argv):
        """One CLI call: (exit code, stdout, {phase: (wall s, device s)}),
        with its wall time and the card's busy time (kernel time sum from
        the profiler); the tool's stderr log is echoed."""
        torch.cuda.synchronize()
        buf, ebuf = io.StringIO(), io.StringIO()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()       # the profiler's set-up and
            try:                        # teardown stay out
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(ebuf):
                    rc = dispatch(argv)
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
    def lf_compare(bwt_file, raw_text, label):
        """Every LF-walk form against its plain version on the seeds and
        segments that checkbwt and bwtcomputessa give it for ``bwt_file``:
        on the rank rows the tools built (sector rows for DNA) and on
        bit-plane rows of the same BWT, the kernel timed in turns (sector,
        bit-plane, bit-plane, sector).  Returns {layout: {max_abs_err, ms,
        plain_ms, bound_ms, bound_by, forms}}; ms, plain_ms and bound_ms
        are summed over the forms the tools launch (verify + harvest)."""
        res = BwtResult.load(bwt_file)
        focc, symmap = res.load_focc(dev)
        if focc.LAYOUT != "sector":
            raise AssertionError("the tools' rank rows for DNA are %s rows, "
                                 "not sector rows" % focc.LAYOUT)
        n = focc.n
        bwt_dev = torch.cat([access(focc, torch.arange(
            a, min(n, a + (1 << 24)), device=dev)).to(torch.uint8)
            for a in range(0, n, 1 << 24)])
        foccs = {"sector": focc,
                 "bitplane": build_focc_device(bwt_dev, focc.sigma,
                                               "bitplane")}
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
        for name in ("lf_walk", "verify_walk", "harvest_walk"):
            k_ms = {lay: 0.0 for lay in foccs}
            for lay in ("sector", "bitplane", "bitplane", "sector"):
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
    if min(path_counts["merge path"][k] for k in KERNELS) < 1:
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
    blocks = _plan_blocks_fixed(nm, opts.max_block_symbols)
    if len(blocks) != 3:
        raise AssertionError("expected 3 blocks, planned %d" % len(blocks))
    s_r, (m_r, e_r) = 0, blocks[-1]
    table = np.zeros(256, np.uint8)
    table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dense = table[text]           # the engine's alphabet compaction
    del text
    ctx = _Ctx(dense, 4, prate, opts, None, 1 << 16, dev, Phases(dev))
    right = _sort_block(ctx, m_r, e_r)
    foccs = {lay: build_focc_from_packed(right.packed, e_r - m_r, 4,
                                         ctx.bits, lay)
             for lay in ("sector", "bitplane")}
    runner = gd.GapRunner(foccs["sector"], ctx.text_dev, ctx.text, s_r, m_r,
                          e_r, right.r_start, right.hist, sample_rate=prate)
    starts, seeds, lens = anchored_lanes(ctx, runner)
    root = "root merge (left %d, right %d ranks" % (m_r - s_r, e_r - m_r)
    gc = chain_compare(runner, foccs, starts, seeds, lens, 3, False,
                       "%s, %d lanes):" % (root, len(starts)))

    # the chain's own two questions, kernel only.  (a) the anchor form
    # over the root's lanes at their full length: the recording walk
    # without the histogram atomic and the sample write
    st, sd, ln, gap, samp, p0, rate, clear, args_of = chain_inputs(
        runner, starts, seeds, lens)
    turns = ("sector", "bitplane", "bitplane", "sector")
    full = {"recording": dict.fromkeys(foccs, 0.0),
            "anchor": dict.fromkeys(foccs, 0.0)}
    for lay in turns:
        fin_r, ms = timed(lambda: gd.chain_walk(
            *args_of(foccs[lay]), sd, ln, gap, samp, p0, rate), reps=3,
            setup=clear)
        full["recording"][lay] += ms / 2
        fin_a, ms = timed(lambda: gd.anchor_walk(*args_of(foccs[lay]), sd,
                                                 ln), reps=3)
        full["anchor"][lay] += ms / 2
        if not torch.equal(fin_r, fin_a):
            raise AssertionError("the anchor form's final ranks differ from "
                                 "the recording form's")
    gap_ref = gap.clone()
    for lay in foccs:
        say("gap_chain %s, %d lanes x %d steps), %s rows: recording form "
            "%.3f ms, anchor form at full length %.3f ms, so histogram "
            "atomic + sample write %.3f ms [%s]"
            % (root, len(starts), int(lens.max()), lay,
               full["recording"][lay], full["anchor"][lay],
               full["recording"][lay] - full["anchor"][lay], smi))

    # (b) the recording form at 2^15 to 2^18 lanes: the outputs do not
    # depend on the lane split
    by_lanes = {}
    for lg in (15, 16, 17, 18):
        ctx.lane_bucket = 1 << lg
        runner.focc = foccs["sector"]
        st_l, sd_l, ln_l = runner._lanes(*anchored_lanes(ctx, runner))
        by_lanes[lg] = dict.fromkeys(foccs, 0.0)
        for lay in turns:
            _f, ms = timed(lambda: gd.chain_walk(
                *args_of(foccs[lay], st_l), sd_l, ln_l, gap, samp, p0, rate),
                reps=3, setup=clear)
            by_lanes[lg][lay] += ms / 2
            if not torch.equal(gap, gap_ref):
                raise AssertionError("the histogram depends on the lane "
                                     "split (%d lanes)" % len(st_l))
        say("gap_chain %s), recording form at %d lanes x %d steps: sector "
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
            _f, r_ms = timed(lambda: gd.chain_walk(
                *args_of(foccs["sector"]), sd, ln, gap, samp, p0, rate),
                reps=3, setup=clear)
            _f, a_ms = timed(lambda: gd.anchor_walk(
                *args_of(foccs["sector"]), sd, ln), reps=3)
            _f, b_ms = timed(lambda: gd.anchor_walk(
                *args_of(foccs["bitplane"]), sd, ln), reps=3)
            say("L2 fetch granularity asked %d, reads back %d: root chain "
                "recording form %.3f ms and anchor form at full length "
                "%.3f ms on sector rows, anchor form %.3f ms on bit-plane "
                "rows [%s]" % (g, got, r_ms, a_ms, b_ms, smi))
    finally:
        l2(g0)
    del ctx, runner, foccs, right, dense, gap, samp, gap_ref

    # ---- 11. report -----------------------------------------------------
    for name, wall, busy in tools:
        say("tool %-36s wall %.3f s, device busy %.3f s [%s]"
            % (name, wall, busy, smi))
    for name, (wall, dev_s, span_s) in sorted(merge_phases.items(),
                                              key=lambda kv: -kv[1][0]):
        say("merge build phase %-18s wall %.3f s, device busy %s, device "
            "span %s [%s]" % (name, wall, "%.3f s" % dev_s if dev_s
                              else "not measured", "%.3f s" % span_s
                              if span_s else "not measured", smi))
    say("peak device memory: single-block path %.3f GiB, merge path %.3f "
        "GiB [%s]" % (peak_single / 2 ** 30, peak_merge / 2 ** 30, smi))
    shutil.rmtree(WORK, ignore_errors=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    if loaded:
        raise AssertionError("JAX or the JAX package was imported: %s"
                             % loaded)
    launches = {k: sum(c[k] for c in path_counts.values()) for k in KERNELS}
    kernels = []
    for name, per_layout, extra in (
            ("lf_walk", lf_merge,
             {"layouts_single_block_path": lf_single}),
            ("gap_chain", gc,
             {"root_full_length_ms": full,
              "root_recording_ms_by_log2_lanes": by_lanes})):
        main = per_layout["sector"]       # the layout the merge path ran
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": max(
                [v["max_abs_err"] for v in per_layout.values()]
                + [v["max_abs_err"] for v in lf_single.values()]),
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
