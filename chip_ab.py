#!/usr/bin/env python3
"""Times the select walk, the Kasai walk, the two kernel forms over
wavelet rows and the FM index's locate and decode visits of this tree
against those of other trees of the port, on one GPU, in turns.

    python3 chip_ab.py --other DIR [--other DIR ...]
                       [--only kasai|select|wavelet|fm] [--seed 0]
                       [--genome-n 1200000011] [--human-n 3200000021]
                       [--alphabet-n 400000009] [--alphabet-mem 2G]

Each ``DIR`` holds a ``bwtb3m_tpu_torch`` package (an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR``, under a directory
that ``.gitignore`` lists); it is imported under another name and builds
its kernels into its own ``build/``.  Its ``kasai_walk`` may take ISA
(before the walk took p0) or p0.  Every case runs the trees in the order
this, others, others reversed, this, each timed over two calls after a
warm one, and their results must be equal.

Kasai (``--only kasai`` or both): on 2^22-symbol texts (DNA, sigma 200,
``chip_smoke.repeats_text``) at 128 and 2^17 lanes, one slab and two;
on ``make_text`` of 16,777,259 and 100,000,003 symbols (the sizes of
``chip_smoke.py``'s ``hwtToLCP`` and ``lcpbit`` paths) at 2^15 and 2^17
lanes; then on ``--genome-n`` symbols of ``chip_smoke.make_text`` and of
``repeats_text`` with as many 10,000-symbol copies per symbol as at
2^22, the SA from ``compute_bwt`` (``bwtonly=1``, ``mem=2G``) and
``compute_sa_device``: one launch over every position at 2^15, 2^16 and
2^17 lanes, and the slab route's launches (slabs of 2^28 positions) at
2^15 and 2^17 lanes per slab.

Select (``--only select`` or both): ``select_walk`` of 2^20 random ranks
(the cap ``select_ssa`` gives) on the build of ``make_text`` of
``--genome-n`` symbols (the Kasai walk's) and of ``--human-n`` symbols
(0: skipped; ``hostmem=4G``).

Wavelet (``--only wavelet`` or all): ``bwt_lf_walk_wm`` and
``bwt_gap_chain_mk_wm``, each tree over its own rows of the same BWT.  At
2^22 symbols over 300, 5,000 and 65,536 symbols (``chip_smoke.py``'s
cases): the final-rank, verify and harvest forms on 131,072 lanes, the
chain's recording form and its two anchor bounds on a merge of two
halves.  Then ``chip_smoke.utf8_corpus`` of ``--alphabet-n`` code points
over 5,000 symbols, built by ``bwtb3m inputtype=utf-8 bwtonly=1``
(``--alphabet-mem``): verify and harvest on checkbwt's and
bwtcomputessa's lanes, and the root merge's chain and anchors.  Beside
each chain, the final-rank walk over the same right region's rows with
the chain's lanes (seeds below the region's n) and its longest lane's
steps: it reads as many sectors a step as the chain's rank descent, so
the chain's time less the walk's is what the chain's own work (the
histogram's atomic, text and gt reads) costs.

FM (``--only fm`` or all): at 2^22 symbols on sector rows (as
``chip_smoke.py``'s step 3c) every tree's locate on 16,384 random ranks
at rate 262,144 (walks of 10^5-10^6 steps, each at its step latency) and
on 131,072 at rate 32, and its decode of the whole text on the ISA lanes
at rate 32.  Then the build of ``make_text`` of ``--genome-n`` symbols
with its samples (``bwtonly=0``: SA rate 32, ISA rate 262,144), every
tree's ``FMIndex`` over the same rank rows and samples: ``extract`` of
2^24 symbols at a seeded offset (each tree's own lane plan and decode
launch, the host copy and the symbol map included), the decode visit
alone on each tree's own plan and on this tree's, and ``locate_walk`` of
2^20 ranks (2^19 at random, 2^19 sampled ones, as ``chip_smoke.py``'s
genome path) at rate 32, outputs equal.  A tree whose two visits take a
persistent grid (its ``_launch`` a ``blocks`` argument: a variant with
lanes that refill) runs both at 1, 2, 4 and 8 blocks per SM.  This tree
alone: its lane plan timed by itself, and its decode launch with the
stores masked (``out_len`` 0) beside the same launch storing, which says
whether the stores or the row reads set the pace.

No ``--only`` runs all four.  Each line carries the card's name and
power limit; the last line is a JSON object of every time.  Imports
nothing of JAX.
"""

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_out")
# the modules the comparisons call, of every tree
MODULES = ("ops.lf_walk", "ops.kasai", "ops.focc_bp", "ops.wavelet_rows",
           "ops.gapbatch", "engine.merge_scaled", "index.fm")


def load_tree(root: str, i: int):
    """The package under ``root`` imported as ``tree<i>_bwtb3m_tpu_torch``:
    the modules the comparisons call."""
    name = "tree%d_bwtb3m_tpu_torch" % i
    pkg = os.path.join(os.path.abspath(root), "bwtb3m_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {k: importlib.import_module("%s.%s" % (name, k)) for k in MODULES}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", required=True)
    ap.add_argument("--only", choices=("kasai", "select", "wavelet", "fm"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-n", type=int, default=1_200_000_011)
    ap.add_argument("--human-n", type=int, default=3_200_000_021)
    ap.add_argument("--alphabet-n", type=int, default=400_000_009)
    ap.add_argument("--alphabet-mem", type=int, default=2 * 1024 ** 3)
    args = ap.parse_args()
    import chip_smoke
    sys.meta_path.insert(0, chip_smoke._BlockJax())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: torch.cuda.is_available() is False")
    from chip_smoke import (dense_ids, level_lanes, make_text, merge_runner,
                            nvidia_smi_line, repeats_text, utf8_corpus,
                            wavelet_case_2_22, write_utf8)
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.engine.result import BwtResult, clear_caches
    from bwtb3m_tpu_torch.engine.ssa import compute_sa_device, seed_segments
    from bwtb3m_tpu_torch.lcp import plcp as lp
    from bwtb3m_tpu_torch.ops.doubling import suffix_array

    trees = {"this": {k: importlib.import_module("bwtb3m_tpu_torch." + k)
                      for k in MODULES}}
    for i, root in enumerate(args.other):
        trees[os.path.basename(os.path.normpath(root))] = load_tree(root, i)
    names = list(trees)
    order = names + names[::-1]
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    report = {"card": smi, "trees": names, "kasai": {}, "select": {},
              "wavelet": {}, "fm": {}}

    def say(msg):
        print("%s [%s]" % (msg, smi), flush=True)

    def timed(fn, reps=2, setup=None):
        """(result, ms per call) over ``reps`` calls after a warm one, 20
        where the warm call took under 5 ms (a launch's noise is tenths
        of a millisecond); ``setup()`` before each call, untimed."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if setup:
            setup()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        if start.elapsed_time(end) < 5.0:
            reps = max(reps, 20)
        total = 0.0
        for _ in range(reps):
            if setup:
                setup()
                torch.cuda.synchronize()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return out, total / reps

    def in_turns(label, run, same, setup=None):
        """``run(name)`` for every tree in turns (``setup(name)`` before
        each call, untimed); ``same(a, b)`` must hold of each tree's
        result against this tree's.  {name: [ms, ms]}."""
        times = {k: [] for k in names}
        outs = {}
        for who in order:
            outs[who], ms = timed(lambda: run(who), setup=setup and (
                lambda: setup(who)))
            times[who].append(ms)
        for who in names[1:]:
            if not same(outs["this"], outs[who]):
                raise AssertionError("%s: %s and this tree differ"
                                     % (label, who))
        say("%s: %s" % (label, ", ".join(
            "%s %s ms" % (k, " / ".join("%.3f" % t for t in v))
            for k, v in times.items())))
        return times, outs["this"]

    def build(text, n, hostmem=0, bwt_only=True):
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        inp = os.path.join(WORK, "ab%d.bin" % n)
        text.tofile(inp)
        t0 = time.monotonic()
        compute_bwt(BwtOptions(input_path=inp, bwt_only=bwt_only, verbose=0,
                               device="cuda", checkpoint=False,
                               host_mem=hostmem or None))
        torch.cuda.synchronize()
        say("n=%d: compute_bwt bwtonly=%d %.3f s"
            % (n, bwt_only, time.monotonic() - t0))
        return inp + ".bwt"

    # ---- the Kasai walk ----------------------------------------------------
    def kasai_arrays(text, sigma, sa):
        """(words, phi, p0, bits, isa) on the card from an SA tensor."""
        words, phi, p0, bits = lp.device_walk_arrays(text, sigma, sa)
        n = sa.shape[0]
        isa = torch.empty(n, dtype=torch.int32, device=dev)
        isa[sa] = torch.arange(n, dtype=torch.int32, device=dev)
        return words, phi, p0, bits, isa

    def kasai_case(label, arrs, n, lanes, slabs):
        """Every tree's walk over ``slabs`` (a list of (a, b)), ``lanes``
        lanes each, the PLCP equal; the steps from this tree's."""
        words, phi, p0, bits, isa = arrs
        bounds = [(a, b) + lp._lane_bounds(a, b, lanes, dev)
                  for a, b in slabs]

        def run(who):
            mod = trees[who]["ops.kasai"]
            takes_isa = list(inspect.signature(
                mod.kasai_walk).parameters)[2] == "isa"
            plcp = torch.zeros(n, dtype=torch.int32, device=dev)
            steps = torch.zeros((), dtype=torch.int64, device=dev)
            for a, b, p, pend in bounds:
                taken = torch.zeros(len(p), dtype=torch.int32, device=dev)
                mod.kasai_walk(words, phi[a:b], isa[a:b] if takes_isa else p0,
                               plcp[a:b], p, torch.zeros_like(p), pend, n, a,
                               bits, taken=taken)
                steps += taken.sum()
            return plcp, steps

        times, (_plcp, steps) = in_turns(
            "kasai %s, %d lanes, %d slab(s)" % (label, lanes, len(slabs)),
            run, lambda x, y: torch.equal(x[0], y[0]))
        report["kasai"]["%s, %d lanes, %d slab(s)" % (label, lanes,
                                                       len(slabs))] = {
            "steps": int(steps), "ms": times}

    # ---- the select walk ---------------------------------------------------
    def select_case(bwt, n, seed, label):
        res = BwtResult.load(bwt)
        focc, _symmap = res.load_focc(dev, wide=False)
        marks, _pos, prate = res.load_preisa()
        words = np.zeros(n // 32 + 1, np.uint32)
        np.bitwise_or.at(words, marks >> 5,
                         np.uint32(1) << (marks & 31).astype(np.uint32))
        bitw = torch.from_numpy(words.view(np.int32)).to(dev)
        del words
        r0 = torch.from_numpy(np.random.default_rng(seed).integers(
            0, n, 1 << 20)).to(dev)
        cap = 2 * (int(prate) + 512)
        foccs = {k: t["ops.focc_bp"].FusedOccSector(focc.rows, focc.C,
                                                     focc.n, focc.sigma)
                 for k, t in trees.items()}
        times, (_r, steps) = in_turns(
            "select %s (2^20 lanes)" % label,
            lambda who: trees[who]["ops.lf_walk"].select_walk(
                foccs[who], bitw, r0, cap),
            lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        report["select"][label] = {"n": n, "lanes": 1 << 20,
                                   "steps": int(steps.sum()),
                                   "marks": len(marks), "ms": times}

    # ---- the two forms over wavelet rows ------------------------------------
    def wm_walks(label, sym, sigma, t16, r0, p0, seg, forms):
        """The walk's ``forms`` of every tree over its own rows built from
        the dense BWT ``sym`` (a device tensor), on the lanes (r0, p0,
        seg), results equal."""
        wms = {k: t["ops.wavelet_rows"].build_wavelet(sym, sigma)
               for k, t in trees.items()}
        steps = int(seg.max())
        calls = {
            "final rank": lambda lw, wm: lw.lf_walk(wm, r0, steps),
            "verify": lambda lw, wm: lw.verify_walk(wm, t16, r0, p0, seg),
            "harvest": lambda lw, wm: torch.cat(lw.harvest_walk(
                wm, r0, p0, seg, 32, 262144))}
        rec = {"lanes": len(r0), "steps": int(seg.sum()),
               "levels": {k: wm.levels for k, wm in wms.items()}}
        for form in forms:
            rec[form], _out = in_turns(
                "wavelet %s, %s (%d lanes, levels %s)"
                % (label, form, len(r0), rec["levels"]),
                lambda who: calls[form](trees[who]["ops.lf_walk"], wms[who]),
                torch.equal)
        return rec

    def wm_merge(label, text16, sigma, s_, m, e, rate):
        """The merge of [s_, m) into [m, e) as the engine runs it, one
        runner per tree over its own rows of the right region: the
        recording form on this tree's anchored lanes (final ranks,
        histogram and samples equal), the anchor form from rank 0 and
        from the top (64 steps), and the final-rank walk over the same
        rows with the chain's lanes and longest lane's steps."""
        runners = {who: merge_runner(t["engine.merge_scaled"], text16, sigma,
                                     s_, m, e, rate, dev)[0]
                   for who, t in trees.items()}
        here = runners["this"]
        sps = here.specs
        kid, starts, seeds, lens = level_lanes(here)
        lb = 64
        tops = np.full(len(kid), sps[0].rbase + sps[0].gap_size)
        bases = np.full(len(kid), sps[0].rbase)
        args_of, bufs = {}, {}
        for who, lv in runners.items():
            lv._ensure_gt(lv._caps(kid, starts + lb))
            kd, st, sd, ln = lv._lanes(kid, starts, seeds, lens)
            common = (lv.focc, lv.text_dev, lv.gt_dev, lv.c_first, lv.table,
                      kd)
            args_of[who] = {
                "chain": common + (st, sd, ln),
                "anchor from rank 0": common + (
                    st + lb, lv._lanes(kid, starts, bases, lens)[2],
                    torch.full_like(ln, lb)),
                "anchor from the top": common + (
                    st + lb, lv._lanes(kid, starts, tops, lens)[2],
                    torch.full_like(ln, lb))}
            bufs[who] = (torch.empty(lv.focc.n + 1, dtype=torch.int32,
                                     device=dev),
                         torch.empty(lv._nsamp, dtype=torch.int32,
                                     device=dev))

        def clear(who):
            bufs[who][0].zero_()
            bufs[who][1].fill_(-1)

        def record(who):
            gb = trees[who]["ops.gapbatch"]
            r = gb.chain_walk_mk(*args_of[who]["chain"], *bufs[who],
                                 rate)
            return r, bufs[who][0], bufs[who][1]

        rec = {"lanes": len(kid), "steps": int(lens.sum()),
               "ranks": int(here.focc.n),
               "levels": {k: lv.focc.levels for k, lv in runners.items()}}
        rec["recording"], _out = in_turns(
            "wavelet %s, chain recording form (%d lanes, %d steps)"
            % (label, len(kid), rec["steps"]), record,
            lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)),
            setup=clear)
        for which in ("anchor from rank 0", "anchor from the top"):
            rec[which], _out = in_turns(
                "wavelet %s, chain %s (%d steps)" % (label, which, lb),
                lambda who: trees[who]["ops.gapbatch"].anchor_walk_mk(
                    *args_of[who][which]), torch.equal)
        # the chain's lanes as final-rank walks over the same rows
        r0 = torch.from_numpy(np.minimum(seeds - sps[0].rbase,
                                         here.focc.n - 1)).to(dev)
        steps = int(lens.max())
        rec["walk on the chain's lanes"], _out = in_turns(
            "wavelet %s, final-rank walk on the chain's lanes (%d lanes x "
            "%d steps)" % (label, len(kid), steps),
            lambda who: trees[who]["ops.lf_walk"].lf_walk(
                runners[who].focc, r0, steps), torch.equal)
        rec["walk_steps"] = len(kid) * steps
        del runners, args_of, bufs
        torch.cuda.empty_cache()
        return rec

    def wm_2_22(sigma):
        """chip_smoke.py's cases at 2^22 symbols over ``sigma``."""
        text, _isa, bwt, lanes = wavelet_case_2_22(sigma, args.seed, dev)
        n = len(text)
        sym = torch.from_numpy(np.ascontiguousarray(bwt, np.int32)).to(dev)
        lanes = [torch.from_numpy(a).to(dev) for a in lanes]
        t16 = torch.from_numpy(text.view(np.int16)).to(dev)
        label = "2^22 sigma=%d" % sigma
        out = {"walk": wm_walks(label, sym, sigma, t16, *lanes,
                                ("final rank", "verify", "harvest"))}
        del sym, t16, lanes
        out["merge"] = wm_merge(label, text, sigma, 0, n // 2, n, 64)
        return out

    def wm_alphabet(n, mem):
        """The alphabet path's shapes: the build of ``utf8_corpus``, the
        tools' verify and harvest lanes, the root merge."""
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        inp = os.path.join(WORK, "corpus.txt")
        codes = utf8_corpus(n, args.seed + 13, device=dev)
        write_utf8(inp, codes)
        t0 = time.monotonic()
        subprocess.run([sys.executable, "-m", "bwtb3m_tpu_torch", "bwtb3m",
                        "inputtype=utf-8", "bwtonly=1", "device=cuda",
                        "mem=%d" % mem, inp], cwd=REPO, check=True,
                       stdout=subprocess.DEVNULL, timeout=1800)
        say("n=%d code points over 5000 symbols: bwtb3m inputtype=utf-8 "
            "bwtonly=1 %.3f s" % (n, time.monotonic() - t0))
        res = BwtResult.load(inp + ".bwt")
        wm, symmap = res.load_wavelet(dev)
        sigma = wm.sigma
        del wm
        clear_caches()
        sym = torch.from_numpy(dense_ids(symmap, res.load_bwt()).astype(
            np.int32)).to(dev)
        dense = dense_ids(symmap, codes)
        del codes
        ranks, positions, prate = res.load_preisa()
        ranks, positions, seg = seed_segments(ranks, positions, n)
        lanes = [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                 for a in (ranks, positions, seg)]
        t16 = torch.from_numpy(dense.view(np.int16)).to(dev)
        out = {"n": n, "walk": wm_walks("alphabet path", sym, sigma, t16,
                                        *lanes, ("verify", "harvest"))}
        del sym, t16, lanes
        torch.cuda.empty_cache()
        mx = BwtOptions(input_path=inp, mem=mem).max_block_symbols
        blocks = trees["this"]["engine.merge_scaled"]._plan_blocks_fixed(
            n, mx)
        m_r, e_r = blocks[-1]
        out["merge"] = wm_merge("alphabet path root merge", dense, sigma, 0,
                                m_r, e_r, int(prate))
        shutil.rmtree(WORK, ignore_errors=True)
        return out

    # ---- the FM index's locate and decode visits ----------------------------
    def fm_case(n, seed):
        from bwtb3m_tpu_torch.index.sampled import SampledISA, SampledSA
        bwt = build(make_text(n, seed), n, bwt_only=False)
        res = BwtResult.load(bwt)
        focc, symmap = res.load_focc(dev)
        ssa = SampledSA.load(res.sa_path, n)
        sisa = SampledISA.load(res.isa_path, n)
        fms = {k: t["index.fm"].FMIndex(
            None, res.sigma, n, ssa, sisa, dev,
            rows=t["ops.focc_bp"].FusedOccSector(focc.rows, focc.C, focc.n,
                                                 focc.sigma),
            symmap=symmap) for k, t in trees.items()}
        rng = np.random.default_rng(seed)
        L = 1 << 24
        off = int(rng.integers(0, n - L))
        ranks = torch.from_numpy(np.concatenate([
            rng.integers(0, n, 1 << 19),
            32 * rng.integers(0, len(ssa.values), 1 << 19)])).to(dev)
        rec = {"n": n, "symbols": L, "offset": off, "ranks": 1 << 20}
        rec["extract"], _out = in_turns(
            "fm n=%d: FMIndex.extract of 2^24 symbols (plan, decode launch, "
            "host copy)" % n, lambda who: fms[who].extract(off, L),
            np.array_equal)

        def plan(who):
            fm = fms[who]
            if hasattr(fm, "decode_plan"):
                return fm.decode_plan(off, L)
            return [torch.from_numpy(a).to(dev) for a in
                    trees[who]["index.fm"].decode_lanes(fm.isa, n, off, L)]

        plans = {who: plan(who) for who in names}
        rec["lanes"] = {who: len(p[0]) for who, p in plans.items()}
        rec["longest"] = {who: int(p[2].max()) for who, p in plans.items()}
        rec["decode"], _out = in_turns(
            "fm n=%d: decode visit alone on each tree's plan (lanes %s, "
            "longest %s)" % (n, rec["lanes"], rec["longest"]),
            lambda who: trees[who]["ops.lf_walk"].decode_walk(
                fms[who].rows, *plans[who], off, L), torch.equal)
        rec["decode_on_this_plan"], _out = in_turns(
            "fm n=%d: decode visit of every tree on this tree's lanes" % n,
            lambda who: trees[who]["ops.lf_walk"].decode_walk(
                fms[who].rows, *plans["this"], off, L), torch.equal)
        rec["locate"], _out = in_turns(
            "fm n=%d: locate_walk of 2^20 ranks at rate 32" % n,
            lambda who: trees[who]["ops.lf_walk"].locate_walk(
                fms[who].rows, ranks, 32),
            lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        r0, p0, seg = plans["this"]
        out = torch.zeros(L, dtype=torch.uint8, device=dev)
        steps = torch.empty(len(ranks), dtype=torch.int64, device=dev)
        # a tree whose two visits take a persistent grid (its launches a
        # ``blocks`` argument): the grid at 1, 2, 4 and 8 blocks per SM
        rec["sweep"] = {}
        for who in names:
            lw = trees[who]["ops.lf_walk"]
            if "blocks" not in inspect.signature(lw._launch).parameters:
                continue
            rec["sweep"][who] = {}
            for per_sm in (1, 2, 4, 8):
                blocks = {v: lw.persistent_grid(dev, len(x), per_sm)
                          for v, x in (("locate", ranks), ("decode", r0))}
                _r, loc_ms = timed(lambda: lw._go(
                    fms[who].rows, ranks, None, steps=steps, rate=32,
                    blocks=blocks["locate"]))
                _r, dec_ms = timed(lambda: lw._go(
                    fms[who].rows, r0, lw._steps_i32(seg), p0, dec=out,
                    base=off, out_len=L, blocks=blocks["decode"]))
                rec["sweep"][who][per_sm] = {
                    "blocks": blocks, "locate_ms": loc_ms,
                    "decode_ms": dec_ms}
                say("fm n=%d: %s, %d blocks per SM (locate %d, decode %d "
                    "blocks): locate %.3f ms, decode %.3f ms" % (
                        n, who, per_sm, blocks["locate"], blocks["decode"],
                        loc_ms, dec_ms))
        # this tree alone: its plan, and its decode launch with the stores
        # masked (out_len 0) beside the same launch storing
        lw = trees["this"]["ops.lf_walk"]
        fm = fms["this"]
        _p, rec["plan_ms"] = timed(lambda: fm.decode_plan(off, L))
        l32 = lw._steps_i32(seg)
        ms = {}
        for label, out_len in (("storing", L), ("stores masked", 0),
                               ("storing again", L)):
            _r, ms[label] = timed(lambda: lw._go(
                fm.rows, r0, l32, p0, dec=out, base=off, out_len=out_len))
        rec["decode_stores"] = ms
        say("fm n=%d: lane plan %.3f ms; decode visit %s (%d lanes, %d "
            "steps)" % (n, rec["plan_ms"], ", ".join(
                "%s %.3f ms" % kv for kv in ms.items()), len(r0),
                int(seg.sum())))
        report["fm"]["genome make_text"] = rec
        del fms, plans, focc
        clear_caches()
        torch.cuda.empty_cache()

    def fm_2_22(seed):
        """The visits at 2^22 on sector rows, as chip_smoke.py's step 3c:
        the locate on 16,384 random ranks at rate 262,144 (walks of 10^5-
        10^6 steps, each lane at its step latency) and on 131,072 at rate
        32, the decode of the whole text on the ISA lanes at rate 32."""
        from bwtb3m_tpu_torch.index.fm import decode_lanes
        from bwtb3m_tpu_torch.index.sampled import SampledISA
        from bwtb3m_tpu_torch.ops.focc_build import build_focc_host
        n = 1 << 22
        rng = np.random.default_rng(seed)
        text = rng.integers(0, 4, n).astype(np.uint8)
        _sa, isa, bwt = suffix_array(text, 4, dev)
        focc = build_focc_host(bwt.astype(np.uint8), 4, dev, "sector")
        rows = {k: t["ops.focc_bp"].FusedOccSector(focc.rows, focc.C, focc.n,
                                                   focc.sigma)
                for k, t in trees.items()}
        r_all = torch.from_numpy(rng.integers(0, n, 131072)).to(dev)
        rec = {}
        for rate, r0 in ((262144, r_all[:16384]), (32, r_all)):
            rec["locate %d" % rate], _out = in_turns(
                "fm 2^22 sector rows: locate_walk of %d ranks at rate %d"
                % (len(r0), rate),
                lambda who: trees[who]["ops.lf_walk"].locate_walk(
                    rows[who], r0, rate),
                lambda a, b: torch.equal(a[0], b[0])
                and torch.equal(a[1], b[1]))
        lanes = [torch.from_numpy(a).to(dev) for a in decode_lanes(
            SampledISA(32, isa[::32], n), n, 0, n)]
        rec["decode 32"], _out = in_turns(
            "fm 2^22 sector rows: decode of the text on %d lanes"
            % len(lanes[0]), lambda who: trees[who]["ops.lf_walk"]
            .decode_walk(rows[who], *lanes, 0, n), torch.equal)
        report["fm"]["2^22 sector rows"] = rec

    if args.only in (None, "fm"):
        fm_2_22(args.seed + 12)
        fm_case(args.genome_n, args.seed + 11)
    kasai_on = args.only in (None, "kasai")
    select_on = args.only in (None, "select")
    if args.only in (None, "wavelet"):
        for sigma in (300, 5000, 65536):
            report["wavelet"]["2^22 sigma=%d" % sigma] = wm_2_22(sigma)
        if args.alphabet_n:
            report["wavelet"]["alphabet path"] = wm_alphabet(
                args.alphabet_n, args.alphabet_mem)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if kasai_on:
        n = 1 << 22
        for label, sigma, text in (
                ("2^22 sigma=4", 4, np.random.default_rng(args.seed + 60)
                 .integers(0, 4, n).astype(np.uint8)),
                ("2^22 sigma=200", 200, np.random.default_rng(args.seed + 61)
                 .integers(0, 200, n).astype(np.uint8)),
                ("2^22 10,000-symbol repeats", 4,
                 repeats_text(n, args.seed + 62))):
            sa = torch.from_numpy(suffix_array(text, sigma, dev)[0]).to(dev)
            arrs = kasai_arrays(text, sigma, sa)
            del sa
            for lanes in (128, 1 << 17):
                for slabs in ([(0, n)], [(0, n // 2), (n // 2, n)]):
                    kasai_case(label, arrs, n, lanes, slabs)
            del arrs
        for n in (16_777_259, 100_000_003):
            dense = np.searchsorted(acgt, make_text(n, args.seed + 1))
            dense = dense.astype(np.uint8)
            sa = torch.from_numpy(suffix_array(dense, 4, dev)[0]).to(dev)
            arrs = kasai_arrays(dense, 4, sa)
            del sa, dense
            for lanes in (1 << 15, 1 << 17):
                kasai_case("n=%d make_text" % n, arrs, n, lanes, [(0, n)])
            del arrs
    ng = args.genome_n
    for label, codes in () if not (kasai_on or select_on) else (
            ("genome make_text", lambda: np.searchsorted(
                acgt, make_text(ng, args.seed + 11)).astype(np.uint8)),
            ("genome repeats", lambda: repeats_text(
                ng, args.seed + 16, copies=ng * 100 >> 22))):
        if not kasai_on and label != "genome make_text":
            continue
        dense = codes()
        bwt = build(acgt[dense], ng)
        if select_on and label == "genome make_text":
            select_case(bwt, ng, args.seed + 12, "genome")
        if not kasai_on:
            continue
        sa, _n = compute_sa_device(bwt, device=dev)
        arrs = kasai_arrays(dense, 4, sa)
        del sa
        for lanes in (1 << 15, 1 << 16, 1 << 17):
            kasai_case(label, arrs, ng, lanes, [(0, ng)])
        slabs = [(a, min(ng, a + (1 << 28))) for a in range(0, ng, 1 << 28)]
        for lanes in (1 << 15, 1 << 17):
            kasai_case(label, arrs, ng, lanes, slabs)
        del arrs, dense
        torch.cuda.empty_cache()
    if select_on and args.human_n:
        nh = args.human_n
        select_case(build(make_text(nh, args.seed + 13), nh, 4 * 1024 ** 3),
                    nh, args.seed + 14, "human genome")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
