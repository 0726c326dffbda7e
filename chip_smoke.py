#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``bwtb3m_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--n 100000003] [--merge-n 400000009]
                          [--genome-n 1200000011] [--genome-hostmem 0]
                          [--human-n 3200000021] [--human-hostmem 4294967296]
                          [--human-bwtonly 1] [--human-checks full]
                          [--alphabet-n 100000007] [--alphabet-mem 640M]
                          [--alphabet32-n 400000009] [--alphabet32-mem 2G]
                          [--index-n 100000003]
                          [--only all|human|alphabet|index|fasta|power]

Phases, in order; any failure exits non-zero and no result line is
printed:

1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
   and the port's native host library (g++), which must have built;
2. build the three kernel libraries from ``bwtb3m_tpu_torch/csrc`` (one
   nvcc each, in parallel): the LF walk (``bwt_lf_walk``, its 64-bit
   form ``bwt_lf_walk_w``, its form over wavelet rows ``bwt_lf_walk_wm``,
   each with the FM index's locate and decode visits, and the select
   kernel ``bwt_lf_select``), the
   gap chain (``bwt_gap_chain_mk``: a single
   pair merge is a level of one; its 64-bit form ``bwt_gap_chain_mk_w``;
   its form over wavelet rows ``bwt_gap_chain_mk_wm``)
   and the Kasai walk of PLCP (``bwt_kasai_plcp``); then a process of
   its own writes the texts of steps 11 and 12 while the card runs the
   steps before them;
3. the LF-walk kernel through each of its entry points (final rank,
   verify visit, harvest visit, select visit) against its plain PyTorch
   version on the card, bit-exact, at n = 2^22 with 131,072 lanes, on
   every rank-row layout: sector and bit-plane rows (sigma 4), bit-plane
   rows (sigma 7) and byte rows (sigma 200); its 64-bit form (final rank,
   verify, harvest) the same way on wide rows doctored so that every
   symbol's occ count crosses 2^32 (the BWT taken as the tail of a text
   with 2^32 - count/2 earlier occurrences of each symbol), and on
   undoctored wide rows, where it must give the narrow form's ranks;
   then (3c) the FM index's locate and decode visits against their plain
   versions, bit-exact, on every family: sector and bit-plane rows
   (sigma 4), bit-plane rows (sigma 7), byte rows (sigma 200), those four
   doctored as wide rows across 2^32 (the 64-bit form) and wavelet rows
   over 300, 5,000 and 65,536 symbols: the locate on 131,072 seeded
   ranks at the sample rate 32 and on 16,384 of them at 262,144 (3.6 x
   10^9 steps), and the decode of the whole text at both rates (at
   262,144 the locate's plain version on 8,192 lanes that the sort's SA
   places 1 to 512 steps before a sampled rank, the decode's on its 16
   lanes cut to 256 steps), each also held to the sort's SA and the
   text; on the wavelet rows over 5,000 and 65,536 symbols also
   ``ops/rank.py::rank_all_symbols_batch`` (torch, no hand kernel) at
   4,096 positions (0, n, block edges, random) against the per-symbol
   ``rank`` on the same rows; then, kernel only, the walk's step rate
   on sector and bit-plane rows of 2^24 and 2^28 random symbols at 2^15
   to 2^18 lanes (rank rows inside and far past the L2);
4. the gap-chain kernel (recording form and both anchor bounds) against
   its plain version, bit-exact: a right region of 2^22 ranks, a left
   block of 2^22 symbols, 65,536 lanes, on the same four layouts; the
   runner's own anchors and chains must then give the ranks of the sort;
   then its 64-bit form through the runner's wide mode on the same
   merge: on wide rows, on doctored rows (the runner's own chains must
   still give the sort's ranks) and with the merge's rank base moved to
   2^32 + 2^20 (the kernel handed the rows' and histogram's pointers
   lowered by as many rows and cells);
4b. the Kasai kernel against its plain version, bit-exact, at n = 2^22 on
   random DNA codes (nibble windows), random bytes of sigma 200 (byte
   windows) and DNA with 100 copies of 10,000-symbol segments (long
   extensions before a lane's first commit), at 2^17 and 128 lanes, over
   the whole text (the device route) and over two slabs (the slab route,
   a > 0); with 128 lanes the plain version runs ``KASAI_CAP`` steps and
   the kernel as many for the comparison; every PLCP is also held to the
   host Phi/Kasai oracle, and the device encoder to the host's;
5. the single-block path through the CLI dispatch with ``device=cuda``
   on a chromosome-sized text (n = 100,000,003 ACGT symbols from
   ``--seed``, random except for 1,000 copies of 1,000-10,000-symbol
   segments with 1% point mutations): ``bwtb3m``; ``checkbwt`` (gok=1);
   ``checkbwt`` on a copy with one BWT symbol changed (gok=0);
   ``bwtcomputessa`` held against the build's own .sa/.isa; then its PLCP:
   ``lcpbit`` (the device route: the doubling sort's SA kept on the card,
   one launch of the Kasai kernel);
6. an independent SA check at 2^22: on a text with a unique smallest
   terminator the circular suffix order equals the plain suffix order,
   which a short numpy prefix doubling (``np.lexsort``) computes here;
7. the LF-walk kernel against its plain version at step 5's shapes, on
   sector rows (what the tools run) and, in turns within the same run,
   on bit-plane rows built from the same BWT (the plain version on
   8,192 of the lanes cut to 256 steps, ``PLAIN_SAMPLE``, the kernel on
   the same and, for its time, on every lane at full length; so in steps
   9 and 10 too);
8. the FASTA path, engine against engine at 16,777,259 symbols: the
   text as a gzipped FASTA of 16 records (one lowercase, two N runs),
   ``fagzToCompact4 rc=0 seed=42`` (its ``.meta`` must hold the N runs,
   its compact the text's codes elsewhere); from that compact ``bwtb3m
   inputtype=compactstream engine=merge mem=67108864`` (five blocks,
   three levels, a carried region), ``engine=merge-legacy`` (mapped onto
   the same engine) and ``engine=doubling`` give the same
   .bwt/.hist/.preisa bytes; ``checkbwt`` (gok=1) of the merge-legacy
   build, ``bwtcomputessa`` of the doubling build and
   ``fa4suffixarraytocompact`` with the ``.meta``, whose (record, offset)
   coordinates must decode to the ``.sa``'s positions; then ``hwtToLCP
   checklcp=1`` on the doubling build, its ``lcpbit``, ``checkLCPBit``
   (lcpok=1) and ``checkLCPBit`` on a copy with one bit moved (lcpok=0,
   exit 1): the host oracle runs at this size, not at step 5's;
8b. the power path: ``bwtb3m engine=merge-legacy bwtonly=0 mem=128M``
   (blocks of 8,388,608) on u^2, u a 10,000,019-symbol text of
   ``make_text`` (n = 20,000,038): every file from the root, which is
   past one block and built by the scaled engine, whose SA samples the
   select kernel ``bwt_lf_select`` takes and whose ISA the harvest
   visit; ``checkbwt`` (gok=1); the .bwt, .preisa, .sa and .isa held to
   the single-block route's (``engine/api.py::_power_files_single``: one
   device sort of u), max_abs_err 0; the select kernel against its plain
   version on the root's rows and lanes (rebuilt from that route's
   files), as step 11 holds it;
9. the merge path at n = 400,000,009 (three blocks of the default
   mem=2G, two merges, checkpointing on): ``bwtb3m bwtonly=1`` (engine
   auto takes the scaled engine), ``checkbwt`` (gok=1), ``bwtcomputessa``
   whose .sa/.isa must agree with the build's .preisa (pos, rank) pairs;
   then the LF-walk kernel against its plain version on that build's
   seeds and segments (the shapes checkbwt and bwtcomputessa gave it),
   on sector and on bit-plane rows;
10. the gap-chain kernel against its plain version at the root merge's
    shapes (268,435,456-symbol left block, 131,564,553-rank right
    region, 65,536 lanes), on sector and on bit-plane rows, and its
    64-bit form on the same lanes (the wide runner's own anchors must
    give them); then, kernel only: the anchor form over the root's lanes
    at their full length (the recording walk without the histogram
    atomic and the sample write), the recording form at 2^15 to 2^18
    lanes, and both with ``cudaLimitMaxL2FetchGranularity`` at its
    default and at 32; then the forced-wide merge path: the 400M build
    once more under ``BWTB3M_FORCE_WIDE=1`` (every merge wide, through
    the 64-bit chain), whose .bwt/.hist/.preisa must equal the narrow
    build's, ``checkbwt`` (gok=1) and ``bwtcomputessa`` (the same
    .sa/.isa bytes) on its wide rows, and the 64-bit LF walk against its
    plain version at those tools' shapes; then ``FMIndex.locate_batch``
    of 2^20 seeded ranks on the wide rows (the locate visit's 64-bit
    form) against the narrow rows' and the .sa (the .meta of a bwtonly=1
    build names no .sa in either package: the script names the one
    bwtcomputessa wrote);
11. the genome path at n = 1,200,000,011 (a vertebrate genome of the
    1.0-1.2 Gbp class; nine blocks at the default mem=2G: levels of 4
    pairs + a carried block, 2 pairs + carry, 1 + carry, root): ``bwtb3m
    bwtonly=0 sasamplingrate=32 isasamplingrate=262144`` (a level of two
    or more pairs is one launch of the chain, the SA/ISA walk takes its
    rank rows from the build's device symbols); ``checkbwt`` in the
    same process and once more in a fresh process from ``.bwt`` (gok=1;
    beside the ``.lcpbit`` read-back below, both host work);
    ``hwtPreIsaToIsa`` (its .isa equals the build's); ``select_ssa`` of
    2^20 ranks held against the .sa samples they name; the FM index over
    the build's rows (``FMIndex.from_bwt_result``): ``locate_batch`` of
    2^20 seeded ranks (the locate visit) held to ``select_ssa`` of the
    same ranks and to the .sa at the sampled ones, and ``bwtdecodeblock
    ref=<text>`` of 2^24 symbols (the decode visit, on a lane at every ISA
    and .sa sample of the range, ``FMIndex.decode_plan``) at a seeded
    offset and across the end of the text (the locate and decode lines
    print their grids, one thread a lane; the decode line its lanes, its
    longest lane and the plan's ms beside the kernel's).  Then every
    kernel of that path against its plain version at the shapes the path
    gave it (the plain version on a sample of lanes, ``PLAIN_SAMPLE`` and
    ``SELECT_CUT``): the select visit, then its persistent grid at 1 to
    8 blocks per SM and its summary at blocks of 2^6 to 2^12 ranks, each
    with its share of summary false hits; the verify and harvest walks on
    checkbwt's and the SA/ISA walk's lanes over the 1.2G rows, and their
    64-bit form on the same rows widened; and ``bwt_gap_chain_mk``
    (recording form and both anchor bounds) on every level of the build
    (4, 2, 1 and 1 merges), and its 64-bit form on the levels of one
    merge, for which the build runs once more through the engine with
    each level's lanes replayed through the kernel and the plain version
    (``replay_level``).  That replay also holds the peak device memory of
    every block sort and level to the figures the engine's gates plan
    with.  Before that replay, the path's PLCP: ``compute_sa_device``
    over the build's rows (the LF-walk kernel's harvest visit at rate
    1), ``compute_plcp_device`` (one launch of the Kasai kernel),
    ``encode_plcp_bits_device`` and ``write_plcp_bytes``; 2^20 positions
    from ``--seed`` held to the memory-mapped text (the rotations at p and
    SA[ISA[p] - 1] share PLCP[p] symbols and differ after them) and to
    the ``.lcpbit`` read back; the Kasai kernel at 2^15 to 2^18 lanes (the
    lane sweep) and
    against its plain version on ``PLAIN_SAMPLE`` lanes.  ``--genome-n``
    of 2^31 or more skips the PLCP (the reference's PLCP takes n < 2^31),
    of 2^32 or more runs the tools' walks through the 64-bit form, and
    ``select_ssa`` only below;
12. the human-genome path at n = 3,200,000,021 (24 blocks at mem=2G,
    levels of 12, 6 and 3 merges, a pair and the root; ``hostmem=4G``):
    ``compute_bwt`` (``bwtonly=1``), each of whose levels is replayed
    right after its own chains as in step 11 (the replay's time, device
    time, memory and launches are not the build's), and ``check_bwt`` of
    the result it returns in the same process (the hand-off);
    ``bwtcomputessa`` at rate 32 / 262144 held to the ``.preisa``;
    ``select_ssa`` of 2^20 ranks held to the ``.sa``; ``checkbwt`` in a
    fresh process from ``.bwt`` with ``--only human`` (62-89 s; the
    default run leaves it to the genome and alphabet paths to stay
    within its time); the verify, harvest and select walks
    against their plain versions (sampled), the first two also through
    the 64-bit form on the same rows widened.
    ``--human-n`` of 2^32 or more runs the wide path (64-bit forms);
    past 2^31 the path has no PLCP, as in the reference;
    ``--human-checks build`` stops after ``check_bwt``; ``--only human``
    runs phases 1, 2 and this one alone (the runs made by hand);
13. alphabets past 256 symbols (after step 11, before step 12): both
    forms over wavelet rows (an 8-ary wavelet matrix, three bits a level
    in 64-byte blocks) against their plain versions at 2^22 over 300,
    5,000 and 65,536 symbols (3, 5 and 6 levels, the uint16 forms) and
    over 150,000 and 1,112,064 (6 and 7 levels, the uint32 forms; D and
    start read from device memory), max_abs_err 0 (the walk's
    final-rank, verify and harvest forms on 131,072 lanes; the chain's
    recording and anchor forms on a merge of two halves, whose histogram
    must be the sort's; past 65,536 symbols also the locate and decode
    visits at rate 32); then two code-point texts as UTF-8, each through
    the same tools (``code_point_path``): ``bwtb3m inputtype=utf-8
    bwtonly=1`` (three blocks, the merge engine, two pair merges through
    ``bwt_gap_chain_mk_wm``), ``bwtcomputessa`` held to the ``.preisa``,
    ``hwtPreIsaToIsa`` (the same ``.isa``), ``bwttestdecodespeed``,
    ``select_ssa`` of 2^20 seeded ranks (the locate visit over the
    wavelet rows, on the .sa of bwtcomputessa, which the script names in
    the .meta) held to the .sa and, at their LF ranks, SA[LF(r)] ==
    (SA[r] - 1) mod n, ``bwtdecodeblock`` of 2^20 symbols held to the
    text (its ``ref=``), the wavelet rows' bytes against the reference's
    OccTable layout's, the walk's verify and harvest forms on the tools'
    lanes over the build's rows, the select's locate visit and the root
    merge's chain against their plain versions (sampled), and
    ``checkbwt`` in a fresh process (gok=1).  First ``--alphabet32-n`` =
    400,000,009 code points over 104,100 (``cjk_corpus``: Zipf over the
    CJK Unified Ideographs, Hangul syllables and CJK Extensions A-G,
    every one present, 1,000 mutated repeats; made by the text writer)
    at ``mem=2G``: dense uint32 ids, 32-bit regions, 6 levels, the
    uint32 forms; its fresh checkbwt runs beside the next build.  Then
    ``--alphabet-n`` = 100,000,007 over 5,000 (``utf8_corpus``: Zipf over
    ASCII, Latin, Greek, Cyrillic and CJK, 1,000 mutated repeats) at
    ``mem=640M``: 16-bit regions, 5 levels, the uint16 forms; its fresh
    checkbwt runs beside ``bwtcodec=rlh`` at 16,777,259 symbols of the
    same kind: ``engine=merge bwtonly=0`` against ``engine=doubling``,
    the same ``.bwt``/``.hist``/``.preisa`` bytes, and ``checkbwt`` of
    the RLH1 file.  ``--only alphabet`` runs phases 1, 2 and this one
    alone;
14. the index path (after step 13): a chromosome-sized reference,
    ``--index-n`` = 100,000,003 bases from ``--seed`` (``make_text``'s
    repeats) as a .pac: ``bwtb3m inputtype=pacterm bwtonly=0
    sasamplingrate=32``; ``bwtb3mtobwa``, its BWA files read back and
    held to the .bwt less its $ row and to the .sa; ``allHamDna
    maxmis=2`` on 10,000 reads of 100 bp from seeded positions of either
    strand with 0-2 seeded substitutions (each read's origin among its
    lines with NM equal to its substitutions; the size of the
    breadth-first frontier), and the search's plain version (the
    depth-first recursion, ``ops/lf.py::hamming_search_plain``) on the 400
    patterns of 200 of them (the same intervals, in order);
    ``probeScanDna`` in ``mode=occ`` and
    ``mode=hwt``, k = 31, on 1,000 probes of 200 bp (equal lines);
    ``bwtdecodeblock`` of 2^20 symbols; the converters: ``bwttohwt
    recreate=1`` (the build's own .hwt bytes), ``hwtToRlHwt verify=1`` (on
    a pacterm build of the first 16,777,259 bases: 72.6 s at 100M on the
    same machine), and
    on an ``inputtype=pac bwtonly=1`` build of the same codes
    ``bwttodnarank`` and ``bwttodnarank256``, read back and held to the
    BWT's ranks at 2^20 seeded positions; both visits at the path's
    shapes against their plain versions (sampled).  ``--only index``
    runs phases 1, 2, 3c and this one alone;
    by hand, ``--only fasta`` runs phases 1, 2 and the FASTA path at the
    genome path's size (``--genome-n`` 1,200,000,011, ``--genome-mem``
    2G): the genome path's text as a gzipped FASTA of 24 records,
    ``fagzToCompact4`` and ``fagzToCompact rc=1`` (host), ``bwtb3m
    inputtype=compactstream bwtonly=1`` from the 2-bit compact and its
    ``checkbwt`` (gok=1), with the tools' walls and the build's busy time;
15. the sharded paths (``parallel/``, after step 11b), on the one card:
    (a) a group of one over NCCL: ``all_reduce``, ``all_gather``,
    ``broadcast`` and a self ``exchange`` on card tensors, then ``bwtb3m
    engine=sharded`` through the CLI on step 5's text (its ``.bwt``
    ``.hist`` ``.preisa`` ``.sa`` ``.isa`` byte for byte step 5's build)
    and ``checkbwt`` of it (gok=1, the LF-walk kernel); (b) two ranks
    sharing the card over gloo (``run_ranks``), on step 8's 16,777,259
    symbols: ``sharded_bwt`` (the pad slots: n is odd) against the
    single-card sort, which equals step 8's ``engine=doubling`` build;
    ``blockwise_bwt_scaled(mesh=)`` at mem=67108864 (five blocks, a
    batched level of two pairs with its lanes cut over the ranks), and
    the same under ``BWTB3M_SHARD_OCC=1`` (the pair merges' rows sharded
    by rank range), each equal to the single-card build on every rank;
    on rank 1 ``bwt_gap_chain_mk`` against ``gap_chain_mk_plain`` on
    every 8th lane of its part of that level; each rank's launch counts
    (``parallel/dryrun.py::run_jobs``) and imported modules (none of
    JAX); (c) three ranks (the odd-even merge-split rounds):
    ``sharded_bwt`` of 4,194,305 symbols against the single-card sort,
    and the time of one staged exchange of 128 MiB.  The ranks of (b)
    and (c) start first, each world from a thread of its own (a process
    takes about 7 s to reach the card, one after the other), and (a) and
    the single-card references run meanwhile, so their times are taken
    beside the ranks' work.
    Step 5's and step 8's files are kept for it as hard links in
    ``smoke_keep/``.  Scaling across cards is not measured (one card).
    ``--only sharded`` runs phases 1, 2 and this one, on a text of
    ``--n`` built there and ``make_text(16,777,259)``;
16. launch counts per path (> 0), kernel times against plain versions
    and bounds, per-phase wall and device time, peak device memory.

The last three lines are the nvidia-smi line, a JSON object of the
kernels, and ``{"ok": true, "device": {...}}``.  A kernel's ``ms``,
``plain_ms`` and ``bound_ms`` there are from the merge path's shapes
(the 400M build's walks; the root merge's chains and anchors, one merge
per launch; for the 64-bit forms the forced-wide 400M path's) or, for
``gap_chain_mk`` (the same entry at the genome build's first level of
four merges; ``levels`` has every level) and the select visit, the
genome path's, on the layout that path runs, for the Kasai kernel
the genome path's PLCP, for the forms over wavelet rows
(``lf_walk_wm``, ``gap_chain_mk_wm``) the 5,000-symbol alphabet path's
and for their uint32 forms (``lf_walk_wm32``, ``gap_chain_mk_wm32``)
that past 65,536 symbols, and for the
FM index's visits (``lf_walk_locate``, ``lf_walk_decode``: every form)
the genome path's (``--only index``: the index path's); ``launches`` is that path's count and ``layouts`` has the same numbers per layout.  Where
the plain version ran on a sample of lanes, ``plain_on`` says so and
``plain_ms`` is that sample's.
``bound_ms`` is the larger of the bytes the call must move once (rank
rows, the text and gt bytes walked, lane arrays, outputs; for the FM
index's visits, whose walks are sparse, the rows' bytes that their steps
read: a row or, on wavelet rows, a block of each level per step, no more
than the rows hold) over 3.35 TB/s
and its integer operations (steps taken times the operations of one
step, counted from the kernel source) over 67 T operations/s, the
card's float32 rate outside the tensor cores, taken for integer
operations too.  The script imports nothing of JAX and nothing of the
JAX package, and refuses both.
"""

import argparse
import contextlib
import copy
import ctypes
import importlib.abc
import io
import json
import os
import resource
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_out")
# the genome paths' inputs, made by a process of their own while the card
# runs the earlier steps
TEXTS = os.path.join(REPO, "smoke_text")
# step 5's and step 8's inputs and builds, kept for the sharded step
KEEP = os.path.join(REPO, "smoke_keep")
STARTED = []                    # every process the run starts
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
    # the same kernel as the power path launches it: the SA samples of a
    # power text's root past one block (engine=merge-legacy bwtonly=0)
    "lf_walk_select_power": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                             "bwtb3m_tpu/engine/ssa.py:468"),
    # the 64-bit forms (wide rank rows, n >= 2^32 or BWTB3M_FORCE_WIDE):
    # second instantiations of the same templates, entries bwt_lf_walk_w
    # (the reference's wide walks _verify_chunk_w / _harvest_chunk_w) and
    # bwt_gap_chain_mk_w (ops/gapwide.py's chain and anchor programs)
    "lf_walk_w": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                  "bwtb3m_tpu/engine/verify.py:201"),
    "gap_chain_mk_w": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                       "bwtb3m_tpu/ops/gapwide.py:76"),
    # the word-window Kasai walk of PLCP (lcpbit, hwtToLCP)
    "kasai": ("bwtb3m_tpu_torch/csrc/kasai.cu",
              "bwtb3m_tpu/lcp/plcp.py:187"),
    # alphabets past 256 symbols: the walk and the chain over wavelet rows
    # (entries bwt_lf_walk_wm, bwt_gap_chain_mk_wm), in place of the
    # reference's legacy walks over its OccTable (checkbwt's
    # _walk_verify_run; _harvest_walk and ops/lf.py::lf_walk beside it) and
    # its legacy engine's chain and anchor steps
    "lf_walk_wm": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                   "bwtb3m_tpu/engine/verify.py:308"),
    "gap_chain_mk_wm": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                        "bwtb3m_tpu/ops/gap.py:50"),
    # their uint32 forms past 65,536 symbols (up to 2^21, 7 levels): the
    # same entries with a symbol width of 4 bytes
    "lf_walk_wm32": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                     "bwtb3m_tpu/engine/verify.py:308"),
    "gap_chain_mk_wm32": ("bwtb3m_tpu_torch/csrc/gap_chain.cu",
                          "bwtb3m_tpu/ops/gap.py:50"),
    # the FM index: the locate and decode visits of the LF-walk kernel (all
    # three forms), in place of the reference's host loops
    # FMIndex.locate_batch and FMIndex.extract
    "lf_walk_locate": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                       "bwtb3m_tpu/index/fm.py:111"),
    "lf_walk_decode": ("bwtb3m_tpu_torch/csrc/lf_walk.cu",
                       "bwtb3m_tpu/index/fm.py:130"),
}
LIBRARIES = ("lf_walk", "gap_chain", "kasai")
# the path whose launches and shapes a row of the kernels line reports
ROW_PATH = {"lf_walk": "merge path", "gap_chain": "merge path",
            "gap_chain_mk": "genome path", "lf_walk_select": "genome path",
            "lf_walk_w": "forced-wide merge path",
            "gap_chain_mk_w": "forced-wide merge path",
            "kasai": "genome LCP path", "lf_walk_wm": "alphabet path",
            "gap_chain_mk_wm": "alphabet path",
            "lf_walk_wm32": "alphabet32 path",
            "gap_chain_mk_wm32": "alphabet32 path",
            "lf_walk_locate": "genome path", "lf_walk_decode": "genome path",
            "lf_walk_select_power": "power path"}
# the kernels each path must launch
NARROW = ("lf_walk", "gap_chain", "gap_chain_mk", "lf_walk_select",
          "lf_walk_locate", "lf_walk_decode")
PHASE_PREFIX = "bwtb3m::"
BLOCKED = ("jax", "jaxlib", "bwtb3m_tpu")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
OPS_PER_S = 67e12               # float32 outside the tensor cores
# integer operations of one step, counted from csrc/focc_rows.cuh and the
# kernels' loops (loads excluded): the row's count and select, the walk's
# own bookkeeping
LF_STEP_OPS = {"sector": 45, "bitplane": 165, "bytes": 150}
CHAIN_STEP_OPS = {"sector": 50, "bitplane": 150, "bytes": 160}
# what a step of a 64-bit form adds: eight compares and adds of the hi
# word against the wrap rows, the 64-bit C or c_first, 64-bit adds
WIDE_STEP_OPS = 24
# a step of csrc/kasai.cu: two wraps (64-bit add, compare, select), two
# windows (index shift, mask, multiply, funnel shift), the XOR, lowest
# bit, popcount and shift, three capped minima, the test; a commit adds
# the store, the l update and the next position's tests; loads excluded
KASAI_STEP_OPS = 40
# a level of a descent over wavelet rows, the least an 8-ary rank needs
# (csrc/focc_rows.cuh::WaveletRows::level and descend, loads excluded; an
# indexed read of a block's word or count counts as no operation): the
# division by 96 (multiply-high, shift) and the offset (4), the block
# address (3), the word index and bit shift (2), the three plane masks of
# the digit (6) and the partial mask (2), per plane word index three XORs
# and two ANDs, the prefix mask (2), AND, popcount and add (3 x 10), the
# pick of the count before the block or its 96 s complement (2), the
# digit table's read and add (3): 52.  The walks' access descent adds the
# digit at i (three shifts, three ANDs, two shift-ors) and the symbol's
# shift-or (10), the chain's rank descent the wanted digit's shift and
# mask (2)
WM_LEVEL_OPS = {"walk": 62, "chain": 54}
# what a step adds beside its levels: D or start and the visit's or the
# chain's own bookkeeping (as LF_STEP_OPS / CHAIN_STEP_OPS less the row)
WM_STEP_OPS = {"walk": 12, "chain": 30}
# what the locate and decode visits add to a step (csrc/lf_walk.cu):
# the locate's test of the rank (a mask or a modulo's compare), its step
# count and the cap's compare; the decode's position decrement with its
# wrap, the text offset with its wrap, the bound's compare and the
# store's address
LOCATE_VISIT_OPS = 4
DECODE_VISIT_OPS = 8
# the plain versions' share of the paths from 100M up: the recording
# chain and the verify / harvest walks run plain on PLAIN_SAMPLE[0] lanes
# spread over the path's lanes, each cut to PLAIN_SAMPLE[1] steps, and the
# select visit on every 64th lane with its cap cut to SELECT_CUT steps;
# the kernel runs on the same cut lanes for the comparison, and on every
# lane at full length for its time.  256 steps keep the run within its
# time: at 1,024 the sampled plain walks took 100 s of a run, and the
# 100M and 400M paths' plain walks over every lane at full length 69 s
# (NVIDIA H100 80GB HBM3, 700 W)
PLAIN_SAMPLE = (8192, 256)
SELECT_CUT = 2048
# the FM index's visits at 2^22 and rate 262,144 (walks of 10^5-10^6
# steps): the kernel on 16,384 seeded lanes (131,072 at rate 32); the
# locate's plain version on 8,192 lanes a few hundred steps before a
# sampled rank, the decode's on its lanes cut to 256 steps
LONG_LANES_2_22 = 16384
# step 13's alphabets at 2^22: 3, 5 and 6 levels of the uint16 forms, 6
# and 7 levels of the uint32 forms (past 12,232 symbols D and start are
# read from device memory)
ALPHABET_2_22 = (300, 5000, 65536, 150_000, 1_112_064)
SAMPLE_2_22 = (8192, 256)


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


def write_fasta(path, codes, nrec, lower):
    """``codes`` (ACGT bytes) as a gzipped FASTA (level 1) of ``nrec``
    records of 60-base lines, record ``lower`` in lowercase, an N run at
    the start of record 3 and one inside record 10 of those records'
    lengths / 1,000 and / 200.  Returns (record bounds, {record: N run as
    (start, end) inside it})."""
    import gzip
    import numpy as np
    n = len(codes)
    bounds = np.linspace(0, n, nrec + 1).astype(np.int64)
    r = int(bounds[1] - bounds[0])
    runs = {2: (0, r // 1000), 9: (r // 3, r // 3 + r // 200)}
    with gzip.open(path, "wb", compresslevel=1) as f:
        for k in range(nrec):
            seq = codes[bounds[k]:bounds[k + 1]].copy()
            if k in runs:
                seq[runs[k][0]:runs[k][1]] = ord("N")
            if k == lower:
                seq += 32
            full = len(seq) // 60
            f.write(b">chr%d\n" % (k + 1))
            f.write(np.concatenate([seq[:60 * full].reshape(full, 60),
                                    np.full((full, 1), 10, np.uint8)],
                                   1).tobytes())
            if len(seq) > 60 * full:
                f.write(seq[60 * full:].tobytes() + b"\n")
    return bounds, runs


def write_texts(jobs):
    """``make_text(n, seed)`` into each ``path`` of ``jobs`` in turn, each
    file complete when it appears under its name; a job ``(path, n, seed,
    "cjk")`` writes ``cjk_corpus(n, seed)`` as UTF-8 there and its code
    points as little-endian uint32 under ``path + ".u32"``, that file
    last."""
    for path, n, seed, *kind in jobs:
        if kind == ["cjk"]:
            codes = cjk_corpus(n, seed)
            write_utf8(path, codes)
            codes.astype("<u4").tofile(path + ".u32.part")
            os.replace(path + ".u32.part", path + ".u32")
            continue
        make_text(n, seed).tofile(path + ".part")
        os.replace(path + ".part", path)


def stop_started():
    """End whatever process the run started and left running."""
    for p in STARTED:
        if p.poll() is None:
            p.kill()
            p.wait()


def repeats_text(n: int, seed: int, copies: int = 100, length: int = 10_000):
    """Random DNA codes (0-3) with ``copies`` exact copies of
    ``length``-symbol segments of itself: lanes of the Kasai walk that
    start inside a copy extend for ``length`` / 8 steps before their first
    commit."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(copies):
        src, dst = rng.integers(0, n - length, 2)
        t[dst:dst + length] = t[src:src + length].copy()
    return t


def utf8_corpus(n: int, seed: int, nsym: int = 5000, copies: int = 1000,
                device="cuda"):
    """Code points (uint32) of ``nsym`` distinct symbols from printable
    ASCII, Latin, Greek, Cyrillic and CJK ideographs, at Zipf frequencies
    (s = 1.0, in that order), every symbol present, with ``copies``
    copies of 1,000-10,000-symbol segments of the text itself with 1%
    point changes (as ``make_text`` makes repeats): the shape of a UTF-8
    natural-language corpus.  The symbols are drawn on ``device`` by the
    inverse of the Zipf CDF (a generator seeded with ``seed``), the
    copies on the host."""
    import numpy as np
    import torch
    pool = np.concatenate([np.arange(0x20, 0x7f), np.arange(0xc0, 0x250),
                           np.arange(0x391, 0x3ca), np.arange(0x400, 0x460),
                           np.arange(0x4e00, 0xa000)])[:nsym]
    p = 1.0 / np.arange(1, nsym + 1)
    cdf = torch.from_numpy(np.cumsum(p / p.sum())).to(device)
    pool_t = torch.from_numpy(pool.astype(np.int32)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    codes = np.empty(n, np.uint32)
    for a in range(0, n, 1 << 26):
        b = min(n, a + (1 << 26))
        u = torch.rand(b - a, generator=gen, device=device,
                       dtype=torch.float64)
        idx = torch.searchsorted(cdf, u).clamp_(max=nsym - 1)
        codes[a:b] = pool_t[idx].cpu().numpy()
    codes[:nsym] = pool
    rng = np.random.default_rng(seed)
    for _ in range(copies):
        ln = int(rng.integers(1000, 10001))
        src, dst = rng.integers(nsym, n - ln, 2)
        seg = codes[src:src + ln].copy()
        mut = rng.random(ln) < 0.01
        seg[mut] = pool[rng.integers(0, nsym, int(mut.sum()))]
        codes[dst:dst + ln] = seg
    return codes


def cjk_pool():
    """The code points of the alphabet past 65,536 symbols, 104,100 of
    them, most common first: the CJK Unified Ideographs (U+4E00-U+9FFF),
    the Hangul syllables (U+AC00-U+D7A3), CJK Extension A (U+3400-U+4DBF),
    Extensions B-F (U+20000-U+2EBEF) and Extension G (U+30000-U+3134F)."""
    import numpy as np
    return np.concatenate([np.arange(0x4e00, 0xa000),
                           np.arange(0xac00, 0xd7a4),
                           np.arange(0x3400, 0x4dc0),
                           np.arange(0x20000, 0x2ebf0),
                           np.arange(0x30000, 0x31350)]).astype(np.uint32)


def cjk_corpus(n: int, seed: int, copies: int = 1000):
    """Code points (uint32) over ``cjk_pool``'s 104,100 at Zipf
    frequencies (s = 1.0, in the pool's order), every one planted at a
    seeded place, with ``copies`` copies of 1,000-10,000-symbol segments
    of the text itself with 1% point changes, as ``utf8_corpus`` makes
    them; on the host (numpy, a generator seeded with ``seed``): the text
    writer's process makes it while the card runs the earlier steps."""
    import numpy as np
    pool = cjk_pool()
    nsym = len(pool)
    p = 1.0 / np.arange(1, nsym + 1)
    cdf = np.cumsum(p / p.sum())
    rng = np.random.default_rng(seed)
    codes = np.empty(n, np.uint32)
    for a in range(0, n, 1 << 25):
        b = min(n, a + (1 << 25))
        idx = np.searchsorted(cdf, rng.random(b - a))
        codes[a:b] = pool[np.minimum(idx, nsym - 1)]
    for _ in range(copies):
        ln = int(rng.integers(1000, 10001))
        src, dst = rng.integers(0, n - ln, 2)
        seg = codes[src:src + ln].copy()
        mut = rng.random(ln) < 0.01
        seg[mut] = pool[rng.integers(0, nsym, int(mut.sum()))]
        codes[dst:dst + ln] = seg
    stride = n // nsym                 # one planted code point a stride
    codes[np.arange(nsym) * stride + rng.integers(0, stride, nsym)] = pool
    return codes


def write_utf8(path: str, codes) -> int:
    """Write code points as UTF-8, in chunks; returns the bytes written."""
    size = 0
    with open(path, "wb") as f:
        for a in range(0, len(codes), 1 << 26):
            data = (codes[a:a + (1 << 26)].astype("<u4").tobytes()
                    .decode("utf-32-le").encode("utf-8"))
            f.write(data)
            size += len(data)
    return size


def wavelet_case_2_22(sigma: int, seed: int, device):
    """The wavelet kernels' case at 2^22 symbols over ``sigma`` dense
    symbols, every symbol present (a generator seeded with seed + sigma):
    (text as the engine's dense ids, uint16 or, past 65,536 symbols,
    uint32, isa, bwt, (ranks, positions, segment lengths) of 131,072
    lanes that end every n / 131,072 positions, as checkbwt's and
    bwtcomputessa's seeds do)."""
    import numpy as np
    from bwtb3m_tpu_torch.engine.merge_scaled import host_symbol_dtype
    from bwtb3m_tpu_torch.ops.doubling import suffix_array
    n = 1 << 22
    rng = np.random.default_rng(seed + sigma)
    text = rng.integers(0, sigma, n).astype(host_symbol_dtype(sigma))
    text[:sigma] = np.arange(sigma)
    _sa, isa, bwt = suffix_array(text.astype(np.int32), sigma, device)
    pos = np.arange(0, n, n // 131072, dtype=np.int64)
    seg = np.diff(np.r_[pos, n])
    start = (pos + seg) % n
    return text, isa, bwt, (isa[start], start, seg)


def level_lanes(level):
    """(kid, starts, seeds, lens) of an anchored ``BatchedGapRunner``, as
    numpy."""
    import numpy as np
    return (np.concatenate([np.full(sp.T, sp.k) for sp in level.specs]),
            np.concatenate([sp.starts for sp in level.specs]),
            np.concatenate([sp.seeds for sp in level.specs]),
            np.concatenate([sp.lens for sp in level.specs]))


def merge_runner(ms, text_ids, sigma: int, s: int, m: int, e: int,
                 rate: int, device):
    """The merge of [s, m) into [m, e) of a text of dense ids (uint16, or
    uint32 past 65,536 symbols) as the engine runs it, by the tree whose
    ``engine.merge_scaled`` is ``ms``: the right block sorted, a
    ``BatchedGapRunner`` of that one merge over its rank rows, anchored.
    Returns (runner, its lanes, the block)."""
    opts = ms.BwtOptions(input_path="x", mem=1 << 40, device="cuda")
    ctx = ms._Ctx(text_ids, sigma, rate, opts, None, 1 << 16, device,
                  ms.Phases(device))
    right = ms._sort_block(ctx, m, e)
    level = ms.BatchedGapRunner(
        ctx.text_dev, ctx.text, sigma, [(s, m, e, right.r_start, right.hist)],
        [right.packed], ctx.bits, lane_bucket=1 << 16, sample_rate=rate)
    level.anchor_all()
    return level, level_lanes(level), right


def dense_ids(symmap, codes):
    """``codes`` as the dense ids (uint16, uint32 past 65,536 symbols) of
    ``BwtResult.load_wavelet``'s symbol map (``symmap[id]`` is the code;
    None where the codes are dense already)."""
    import numpy as np
    dt = np.uint16 if symmap is None or len(symmap) <= 1 << 16 \
        else np.uint32
    if symmap is None:
        return np.asarray(codes).astype(dt)
    table = np.zeros(int(symmap.max()) + 1, dt)
    table[symmap] = np.arange(len(symmap))
    return table[codes]


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
    ap.add_argument("--human-n", type=int, default=3_200_000_021,
                    help="human-genome path text length (24 blocks at "
                    "mem=2G; 0 skips the path)")
    ap.add_argument("--human-mem", type=int, default=2 * 1024 ** 3,
                    help="mem= of the human-genome path")
    ap.add_argument("--human-hostmem", type=int, default=4 * 1024 ** 3,
                    help="hostmem= of the human-genome path's build")
    ap.add_argument("--human-bwtonly", type=int, default=1, choices=(0, 1),
                    help="bwtonly= of the human-genome build (0: the SA/ISA "
                    "walk and the .hwt as well)")
    ap.add_argument("--human-checks", default="full",
                    choices=("full", "build"),
                    help="build: only the build and check_bwt of its "
                    "result; full: also every level replayed against the "
                    "plain version, the SA tools, checkbwt in a fresh "
                    "process (--only human) and the kernels against their "
                    "plain versions")
    ap.add_argument("--alphabet-n", type=int, default=100_000_007,
                    help="alphabet path text length (code points over "
                    "5,000 symbols; 0 skips the path)")
    ap.add_argument("--alphabet-mem", type=int, default=640 * 1024 ** 2,
                    help="mem= of the alphabet path's build")
    ap.add_argument("--alphabet32-n", type=int, default=400_000_009,
                    help="length of the alphabet path's text past 65,536 "
                    "symbols (code points over 104,100 symbols; 0 skips "
                    "it)")
    ap.add_argument("--alphabet32-mem", type=int, default=2 * 1024 ** 3,
                    help="mem= of that text's build")
    ap.add_argument("--index-n", type=int, default=100_000_003,
                    help="index path reference length (a chromosome; 0 "
                    "skips the path)")
    ap.add_argument("--only", default="all",
                    choices=("all", "human", "alphabet", "index", "fasta",
                             "sharded", "power"),
                    help="human / alphabet: the environment, the kernel "
                    "build and that path alone; index: the locate and "
                    "decode visits at 2^22 and the index path; fasta (by "
                    "hand): the genome text as a gzipped FASTA through "
                    "fagzToCompact4 and fagzToCompact rc=1, a build from "
                    "the first and its checkbwt, at --genome-n and "
                    "--genome-mem; sharded: step 15 alone, on a text of "
                    "--n built here with the default engine and on "
                    "make_text(16,777,259) in place of step 8's FASTA; "
                    "power: step 8b alone")
    args = ap.parse_args()
    t_start = time.monotonic()
    sys.meta_path.insert(0, _BlockJax())

    import numpy as np
    import torch

    # ---- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = nvidia_smi_line()

    def lap(step):
        """The time since the start, before each step of the run."""
        say("elapsed before step %s: %.3f s [%s]"
            % (step, time.monotonic() - t_start, smi))

    say("gpu: %s | torch %s, CUDA %s, %d device(s)"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))

    from bwtb3m_tpu_torch import native
    from bwtb3m_tpu_torch.apps import hamdna
    from bwtb3m_tpu_torch.cli import dispatch
    from bwtb3m_tpu_torch.cli.prep import read_compact4_meta
    from bwtb3m_tpu_torch.index.bwa import read_bwa_bwt, read_bwa_sa
    from bwtb3m_tpu_torch.index.dnarank import DNARank
    from bwtb3m_tpu_torch.index.fm import FMIndex, decode_lanes
    from bwtb3m_tpu_torch.index.sampled import SampledISA
    from bwtb3m_tpu_torch.io import compact, formats
    from bwtb3m_tpu_torch.io.pac import write_pac
    from bwtb3m_tpu_torch.engine import merge_scaled
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.engine.result import BwtResult, write_bwt
    from bwtb3m_tpu_torch.engine.ssa import (load_sampled_array,
                                             seed_segments, select_ssa)
    from bwtb3m_tpu_torch.engine.verify import check_bwt
    from bwtb3m_tpu_torch.ops import _build
    from bwtb3m_tpu_torch.engine.ssa import compute_sa_device
    from bwtb3m_tpu_torch.lcp import plcp as lp
    from bwtb3m_tpu_torch.ops import gapbatch as gb
    from bwtb3m_tpu_torch.ops import kasai as kas
    from bwtb3m_tpu_torch.ops import lf_walk as lw
    from bwtb3m_tpu_torch.ops.lf import hamming_search_plain
    from bwtb3m_tpu_torch.ops import wavelet_rows as wr
    from bwtb3m_tpu_torch.ops import wideocc as pw
    from bwtb3m_tpu_torch.ops.devzip import bits_for, rows_from_host_bwt
    from bwtb3m_tpu_torch.ops.doubling import suffix_array
    from bwtb3m_tpu_torch.ops.focc import access
    from bwtb3m_tpu_torch.ops.rank import rank_all_symbols_batch
    from bwtb3m_tpu_torch.ops.focc_build import (build_focc_concat,
                                                 build_focc_device,
                                                 build_focc_from_packed,
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

    # the genome and human-genome texts, written by a process of their own
    # (the genome's first) while the card runs the steps before theirs
    # and the alphabet path's text past 65,536 symbols
    jobs = ([] if args.only != "all" or not args.genome_n else
            [(os.path.join(TEXTS, "genome.bin"), args.genome_n,
              args.seed + 11)]) + (
        [(os.path.join(TEXTS, "cjk.txt"), args.alphabet32_n, args.seed + 21,
          "cjk")] if args.only in ("all", "alphabet") and args.alphabet_n
        and args.alphabet32_n else []) + (
        [(os.path.join(TEXTS, "human.bin"), args.human_n, args.seed + 13)]
        if args.only in ("all", "human") and args.human_n else [])
    if jobs:
        shutil.rmtree(TEXTS, ignore_errors=True)
        os.makedirs(TEXTS)
        STARTED.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
             "import chip_smoke; chip_smoke.write_texts(%r)" % (REPO, jobs)],
            cwd=REPO))

    def take_text(name, dst, dtype=np.uint8):
        """The text the writer made under ``name``, moved to ``dst``:
        (text as ``dtype``, seconds waited for it)."""
        src = os.path.join(TEXTS, name)
        t0 = time.monotonic()
        while not os.path.exists(src):
            if STARTED[0].poll() is not None and not os.path.exists(src):
                raise AssertionError("the text writer ended without %s"
                                     % name)
            time.sleep(0.2)
        os.replace(src, dst)
        return np.fromfile(dst, dtype), time.monotonic() - t0

    def keep_files(name, paths):
        """Hard links in KEEP to a step's files, for the sharded step at
        the end of the run: {key: kept path}."""
        os.makedirs(KEEP, exist_ok=True)
        kept = {}
        for key, path in paths.items():
            kept[key] = os.path.join(KEEP, "%s.%s" % (name, key))
            if os.path.exists(kept[key]):
                os.remove(kept[key])
            os.link(path, kept[key])
        return kept

    def start_checkbwt(inp, bwt_file, inputtype="bytestream"):
        """checkbwt in a fresh process from .bwt, started: (process, its
        start)."""
        p = subprocess.Popen(
            [sys.executable, "-m", "bwtb3m_tpu_torch", "checkbwt",
             "inputtype=" + inputtype, "device=cuda", inp, bwt_file],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        STARTED.append(p)
        return p, time.monotonic()

    def finish_checkbwt(started, label, beside="", needle="decode"):
        """Wait for a fresh-process checkbwt: gok=1 from the file (its log
        holding ``needle``), or fail; its wall from its start, with the
        interpreter's."""
        p, t0 = started
        out, err = p.communicate(timeout=900)
        wall = time.monotonic() - t0
        sys.stderr.write(err)
        say("checkbwt (%s, fresh process, from .bwt%s): exit %d, wall %.3f "
            "s with the interpreter's start | %s [%s]"
            % (label, beside, p.returncode, wall, out.strip(), smi))
        if p.returncode != 0 or "gok=1" not in out or needle not in err:
            raise AssertionError("checkbwt in a fresh process did not "
                                 "print gok=1 from the file (%s)" % needle)
        return wall

    def reset_counts():
        lw.reset_launch_counts()
        gb.reset_launch_counts()
        kas.kasai_walk.launches = 0

    def counts(launches=None):
        """This process's launch counts by kernel; or those a rank of the
        sharded step reported (``parallel/dryrun.py::run_jobs``)."""
        G = launches["gap_chain"] if launches else gb.LAUNCHES
        L = launches["lf_walk"] if launches else lw.LAUNCHES
        chain = G["chain"] + G["anchor"]
        return {"lf_walk": L["none"] + L["verify"] + L["harvest"],
                "lf_walk_wm": L["none_wm"] + L["verify_wm"]
                + L["harvest_wm"],
                "gap_chain_mk_wm": G["chain_wm"] + G["anchor_wm"],
                "lf_walk_wm32": L["none_wm32"] + L["verify_wm32"]
                + L["harvest_wm32"],
                "gap_chain_mk_wm32": G["chain_wm32"] + G["anchor_wm32"],
                "lf_walk_select": L["select"],
                "lf_walk_w": L["none64"] + L["verify64"] + L["harvest64"],
                "gap_chain": chain, "gap_chain_mk": chain,
                "gap_chain_mk_w": G["chain64"] + G["anchor64"],
                "kasai": 0 if launches else kas.kasai_walk.launches,
                "lf_walk_locate": L["locate"] + L["locate64"]
                + L["locate_wm"] + L["locate_wm32"],
                "lf_walk_decode": L["decode"] + L["decode64"]
                + L["decode_wm"] + L["decode_wm32"],
                "gap_chain_mk (chain form)": G["chain"],
                "gap_chain_mk (anchor form)": G["anchor"],
                "lf_walk (by visit)": dict(L)}

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
        """Largest |a - b| as int64, over chunks of 2^26 elements: the
        histograms of a genome's levels hold 10^9 cells."""
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.dtype == b.dtype and torch.equal(a, b):
            return 0
        a, b = a.reshape(-1), b.reshape(-1)
        return max(int((a[i:i + (1 << 26)].long()
                        - b[i:i + (1 << 26)].long()).abs().max())
                   for i in range(0, a.numel(), 1 << 26))

    def cells_total(gap):
        """The sum of a histogram's cells; the narrow chain's int32 cells
        are uint32 (``ops/devzip.py::gap_cum``)."""
        total = int(gap.sum())
        if gap.dtype == torch.int32:
            total += int((gap < 0).sum()) << 32
        return total

    @contextlib.contextmanager
    def uncounted():
        """Launches made to hold a kernel to its plain version inside a
        path's run are not the path's: the counts are put back."""
        saved = (dict(gb.LAUNCHES), dict(lw.LAUNCHES), lw.lf_walk.launches,
                 kas.kasai_walk.launches)
        try:
            yield
        finally:
            gb.LAUNCHES.update(saved[0])
            lw.LAUNCHES.update(saved[1])
            lw.lf_walk.launches = saved[2]
            kas.kasai_walk.launches = saved[3]

    def errors_in(tree):
        """Every ``max_abs_err`` (and ``..._max_abs_err``) in a nest of
        dicts and lists."""
        if isinstance(tree, dict):
            for k, v in tree.items():
                if str(k).endswith("max_abs_err"):
                    yield v
                else:
                    yield from errors_in(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from errors_in(v)

    def bound(nbytes, nops):
        """(ms, which): the least time the card could take for a call
        that must move ``nbytes`` once and do ``nops`` operations."""
        by = nbytes / HBM_BYTES_PER_S * 1e3
        op = nops / OPS_PER_S * 1e3
        return max(by, op), "bytes" if by >= op else "operations"

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def is_wide(focc):
        return isinstance(focc, pw.WideOcc)

    def is_wavelet(focc):
        return isinstance(focc, wr.WaveletRows)

    def rows_bytes(focc):
        """The rank rows' bytes: the wavelet rows' blocks and tables, or
        the fused rows."""
        if is_wavelet(focc):
            return nbytes(focc.blocks, focc.Zc, focc.start, focc.D)
        return nbytes(focc.rows)

    def chain_step_ops(focc, layout):
        if is_wavelet(focc):
            return (WM_LEVEL_OPS["chain"] * focc.levels
                    + WM_STEP_OPS["chain"])
        return CHAIN_STEP_OPS[layout] + (WIDE_STEP_OPS if is_wide(focc)
                                         else 0)

    def widened(focc):
        """Narrow rank rows of fewer than 2^32 symbols as wide rows: no occ
        word wraps there, so every wrap row is padding and C is the same
        in int64; what the 64-bit forms take at a path's own shapes without
        a second build of the rows."""
        C = gb.word_values(focc, focc.C)
        return pw.widen_focc(focc, [np.zeros(0, np.int64)] * focc.sigma,
                             C[1:] - C[:-1], focc.n)

    def chain_words(focc, a):
        """Host ranks as the chain's words on the card: uint32 bits in
        int32, int64 on wide rows."""
        if is_wide(focc):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)
        return torch.from_numpy(gb.u32_bits(a)).to(dev)

    tools = []

    def run_tool(name, argv, fn=None, profile=True):
        """One CLI call (or ``fn()``, a library call that returns an exit
        code): (exit code, stdout, {phase: (wall s, device s)}), with its
        wall time (less ``run_tool.replay_s``, what a replay inside the
        call adds) and the card's busy time (kernel time sum from the
        profiler; with ``profile=False`` not measured: a replay's plain
        versions launch 10^5-10^6 small kernels, whose profiler events
        would take minutes to sum); the tool's stderr log is echoed."""
        torch.cuda.synchronize()
        raw, ebuf = io.BytesIO(), io.StringIO()
        # text and bytes (sys.stdout.buffer: bwtdecodeblock) alike
        buf = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
        run_tool.replay_s = 0.0
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
              if profile else contextlib.nullcontext()) as prof:
            t0 = time.monotonic()       # the profiler's set-up and
            try:                        # teardown stay out
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(ebuf):
                    rc = fn() if fn else dispatch(argv)
                torch.cuda.synchronize()
            finally:
                sys.stderr.write(ebuf.getvalue())
            wall = time.monotonic() - t0 - run_tool.replay_s
        evs = prof.key_averages() if profile else []
        prof_s = time.monotonic() - t0 - wall - run_tool.replay_s
        cuda = torch.autograd.DeviceType.CUDA
        busy_us = sum(e.self_device_time_total for e in evs
                      if e.device_type == cuda and not e.is_user_annotation)
        # per engine phase: the device time of the kernels launched inside
        # its span (host-side range) and the span on the card's timeline;
        # the phases are the keys of the build's ``phases (wall s)`` line
        # (the tracer's other ``bwtb3m::`` spans nest over them)
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
                  for k in sorted(walls)}
        tools.append((name, wall, busy_us / 1e6 if profile else None))
        buf.flush()
        run_tool.out_bytes = raw.getvalue()
        buf.detach()
        out = run_tool.out_bytes.decode("utf-8", "replace")
        say("%s: exit %d, wall %.3f s, device busy %s%s%s | %s"
            % (name, rc, wall, "%.3f s" % (busy_us / 1e6) if busy_us
               else "not measured", " (less a replay of %.3f s inside the "
               "call)" % run_tool.replay_s if run_tool.replay_s else "",
               ", the profiler's summary %.3f s" % prof_s if profile
               else "",
               out.strip().replace("\n", " ") if len(out) < 2000
               else "%d bytes on stdout" % len(run_tool.out_bytes)))
        run_tool.log = ebuf.getvalue()
        run_tool.wall = wall
        return rc, out, phases

    def lf_compare(bwt_file, raw_text, label,
                   layouts=("sector", "bitplane"),
                   forms=("lf_walk", "verify_walk", "harvest_walk"),
                   wide=False, sample=None):
        """Every LF-walk form against its plain version on the seeds and
        segments that checkbwt and bwtcomputessa give it for ``bwt_file``:
        on the rank rows the tools built (sector rows for DNA), on
        bit-plane rows of the same BWT and (``sector_w``) on the tools'
        rows widened, through the 64-bit form, the kernel timed in turns
        (for example sector, bit-plane, bit-plane, sector), for the
        ``layouts`` and ``forms`` asked; ``wide``: the tools' rows are the
        wide rows, the kernel's 64-bit form.
        ``sample`` = (lanes, steps): the plain version runs on that many
        lanes spread over the seeds, each cut to that many steps, and the
        kernel on the same cut lanes (its time on every lane is ``ms``).
        Returns {layout: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
        forms}}; ms, plain_ms and bound_ms are summed over the forms the
        tools launch (verify + harvest)."""
        res = BwtResult.load(bwt_file)
        focc, symmap = res.load_focc(dev, wide=wide)
        if focc.LAYOUT != "sector" or is_wide(focc) != wide:
            raise AssertionError("the tools' rank rows for DNA are %s%s "
                                 "rows" % ("wide " if is_wide(focc) else "",
                                           focc.LAYOUT))
        n = focc.n
        foccs = {"sector": focc}
        if "sector_w" in layouts:
            foccs["sector_w"] = widened(focc)
        if "bitplane" in layouts:
            narrow = focc.focc if wide else focc
            bwt_dev = torch.cat([access(narrow, torch.arange(
                a, min(n, a + (1 << 24)), device=dev)).to(torch.uint8)
                for a in range(0, n, 1 << 24)])
            foccs["bitplane"] = build_focc_device(bwt_dev, focc.sigma,
                                                  "bitplane", wide=wide)
            del bwt_dev
        ranks, positions, _rate = res.load_preisa()
        ranks, positions, seg = seed_segments(ranks, positions,
                                              len(raw_text))
        table = np.zeros(256, np.uint8)
        table[symmap] = np.arange(len(symmap))
        t_dev = torch.from_numpy(table[raw_text]).to(dev)
        steps, total = int(seg.max()), int(seg.sum())
        step_ops = {lay: LF_STEP_OPS[f.LAYOUT]
                    + (WIDE_STEP_OPS if is_wide(f) else 0)
                    for lay, f in foccs.items()}

        def lanes_of(rk, ps, sl):
            return [torch.from_numpy(a).to(dev) for a in (rk, ps, sl)]

        full = lanes_of(ranks, positions, seg)
        if sample:
            pick = np.linspace(0, len(ranks) - 1, sample[0]).astype(np.int64)
            cut = lanes_of(ranks[pick], positions[pick],
                           np.minimum(seg[pick], sample[1]))

        def runs(f, lanes):
            r0, p0, sl = lanes
            st = int(sl.max())
            return {
                "lf_walk": (lambda: lw.lf_walk(f, r0, st),
                            lambda: lw.lf_walk_plain(f, r0, st)),
                "verify_walk": (
                    lambda: lw.verify_walk(f, t_dev, r0, p0, sl),
                    lambda: lw.verify_walk_plain(f, t_dev, r0, p0, sl)),
                "harvest_walk": (
                    lambda: torch.cat(lw.harvest_walk(f, r0, p0, sl, 32,
                                                      262144)),
                    lambda: torch.cat(lw.harvest_walk_plain(
                        f, r0, p0, sl, 32, 262144))),
            }

        def work(f):
            """(bytes moved once, steps) of each form on every lane."""
            wb = 8 if is_wide(f) else 4
            lane_io = len(ranks) * wb
            return {"lf_walk": (nbytes(f.rows) + 2 * lane_io
                                + 4 * len(ranks), len(ranks) * steps),
                    "verify_walk": (nbytes(f.rows, t_dev) + 3 * lane_io
                                    + 8 * len(ranks), total),
                    "harvest_walk": (nbytes(f.rows) + 3 * lane_io
                                     + 4 * len(ranks)
                                     + wb * (-(-n // 32) - (-n // 262144)),
                                     total)}

        out = {lay: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0, "bound_by": "bytes", "forms": {}}
               for lay in foccs}
        if sample:
            for o in out.values():
                o["plain_on"] = {"lanes": sample[0],
                                 "steps_at_most": sample[1]}
        order = list(foccs)
        for name in forms:
            k_ms = {lay: 0.0 for lay in foccs}
            for lay in order + order[::-1]:
                k, ms = timed(runs(foccs[lay], full)[name][0], reps=3)
                k_ms[lay] += ms / 2
            for lay, f in foccs.items():
                kern, plain = runs(f, cut if sample else full)[name]
                k = kern()
                p, p_ms = timed(plain, warm=False)
                err = max_err(k, p)
                nb, nsteps = work(f)[name]
                b_ms, b_by = bound(nb, nsteps * step_ops[lay])
                say("kernel %-12s %s, %s%s rows (n=%d, %d lanes, %d steps "
                    "max): max_abs_err %d, kernel %.3f ms, plain %.3f ms%s, "
                    "bound %.3f ms (%s)"
                    % (name, label, "wide " if is_wide(f) else "",
                       f.LAYOUT, n,
                       len(ranks), steps, err, k_ms[lay], p_ms,
                       " on %d lanes of %d steps at most" % tuple(sample)
                       if sample else "", b_ms, b_by))
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
            say("kernel lf_walk%s, the tools' forms (verify_walk + "
                "harvest_walk) on the %s, %s rows: kernel %.3f ms, plain "
                "%.3f ms, bound %.3f ms"
                % (" (64-bit form)" if is_wide(foccs[lay]) else "", label,
                   foccs[lay].LAYOUT, o["ms"], o["plain_ms"], o["bound_ms"]))
        if "sector_w" in out:
            say("kernel lf_walk verify + harvest, %s, sector rows: 64-bit "
                "form %.3f ms, narrow form %.3f ms: %.3f x [%s]"
                % (label, out["sector_w"]["ms"], out["sector"]["ms"],
                   out["sector_w"]["ms"] / out["sector"]["ms"], smi))
        return out

    path_counts = {}

    def ssa_agrees_with_preisa(bwt_file, label):
        """The .sa (rate 32) and .isa (rate 262144) beside ``bwt_file``
        agree with its .preisa (pos, rank) pairs; returns the preisa
        rate."""
        prefix = bwt_file[:-4]
        pr, pp, prate = BwtResult.load(bwt_file).load_preisa()
        _r, sa_s = load_sampled_array(prefix + ".sa")
        _r, isa_s = load_sampled_array(prefix + ".isa")
        on_isa = pp % 262144 == 0
        on_sa = pr % 32 == 0
        if not (np.array_equal(isa_s[pp[on_isa] // 262144], pr[on_isa])
                and np.array_equal(sa_s[pr[on_sa] // 32], pp[on_sa])
                and on_isa.sum() == len(isa_s)):
            raise AssertionError("bwtcomputessa's .sa/.isa disagree with the "
                                 "%s's .preisa" % label)
        say("bwtcomputessa .sa/.isa agree with the %s's .preisa: %d ISA "
            "samples, %d SA samples at preisa pairs"
            % (label, int(on_isa.sum()), int(on_sa.sum())))
        return prate

    def select_agrees_with_sa(bwt_file, seed):
        """``select_ssa`` of 2^20 ranks that the .sa samples (rate 32)
        beside ``bwt_file`` name, held to those samples; returns the
        ranks."""
        _r, sa_s = load_sampled_array(bwt_file[:-4] + ".sa")
        rng = np.random.default_rng(seed)
        want = 32 * rng.integers(0, len(sa_s), 1 << 20)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = select_ssa(bwt_file, want, device=dev)
        t_sel = time.monotonic() - t0
        if not np.array_equal(got, sa_s[want // 32]):
            raise AssertionError("select_ssa disagrees with the .sa samples")
        say("select_ssa: 2^20 ranks agree with the .sa samples they name, "
            "%.3f s wall [%s]" % (t_sel, smi))
        return want

    def false_hit_share(summ, shift, n, marks):
        """(share of ranks whose summary bit is set, share of ranks whose
        summary bit is set though they are no mark): the steps of walks
        that visit ranks at random which read the exact bitmap word, and
        those of them that find no mark there."""
        nblk = -(-n // (1 << shift))
        w = lw.from_u32_bits(summ)
        bits = ((w[:, None] >> torch.arange(32, device=w.device)) & 1) \
            .reshape(-1)[:nblk].bool()
        start = torch.arange(nblk, device=w.device, dtype=torch.int64) \
            << shift
        covered = int((n - start).clamp(max=1 << shift)[bits].sum())
        return covered / n, (covered - marks) / n

    def select_sweep(focc, bitw, r_all, cap, kr, ks_, n, marks, label):
        """The select kernel alone over the same lanes: its persistent
        grid at 1, 2, 4 and 8 blocks per SM (blocks x 256 x SMs resident
        lanes where the SM holds them: the ptxas register line in the
        build log says whether it does), then the summary's block at
        2^6 to 2^12 ranks, each with its share of summary false hits;
        every run must give the wrapper's results."""
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        r32 = lw.as_u32_bits(r_all)
        out = {"sms": sms, "by_blocks": {}, "by_summary_shift": {}}

        def run(summ, shift, per_sm):
            (rk, sk), ms = timed(lambda: lw._launch_select(
                focc, bitw, summ, r32, cap, sms * per_sm, shift), reps=2)
            if not (torch.equal(lw.from_u32_bits(rk), kr)
                    and torch.equal(sk.long(), ks_)):
                raise AssertionError("the select kernel's results depend on "
                                     "its grid or its summary")
            return ms

        steps = int(ks_.sum())
        with uncounted():
            summ = lw.select_summary(bitw)
            for per_sm in (1, 2, 4, 8):
                ms = run(summ, lw.SUMMARY_SHIFT, per_sm)
                resident = per_sm * sms * 256
                out["by_blocks"][per_sm] = {"ms": ms,
                                            "resident_lanes": resident}
                say("kernel lf_walk select sweep, %s: %d blocks per SM "
                    "(%d resident lanes), summary 2^%d: %.3f ms (%.2f G "
                    "steps/s) [%s]" % (label, per_sm, resident,
                                       lw.SUMMARY_SHIFT, ms,
                                       steps / ms / 1e6, smi))
            for shift in (6, 8, 10, 12):
                summ = lw.select_summary(bitw, shift)
                ms = run(summ, shift, lw.SELECT_BLOCKS_PER_SM)
                read, false = false_hit_share(summ, shift, n, marks)
                out["by_summary_shift"][shift] = {
                    "ms": ms, "summary_bytes": nbytes(summ),
                    "exact_read_share": read, "false_hit_share": false}
                say("kernel lf_walk select sweep, %s: summary 2^%d (%d "
                    "bytes), %d blocks per SM: %.3f ms; ranks whose "
                    "summary bit is set %.5f, of them no mark (false hits) "
                    "%.5f of all ranks [%s]"
                    % (label, shift, nbytes(summ), lw.SELECT_BLOCKS_PER_SM,
                       ms, read, false, smi))
        return out

    def select_compare(bwt_file, want_ranks, label, sweep=False):
        """The select visit on every lane ``select_ssa`` gave it (timed),
        and against its plain version on every 64th lane with the cap cut
        to ``SELECT_CUT`` steps, the kernel on the same (a lane without a
        hit within the cap ends with -1 in both); with ``sweep``, also
        ``select_sweep``."""
        res = BwtResult.load(bwt_file)
        focc, _symmap = res.load_focc(dev, wide=False)
        pr_ranks, _pp, prate = res.load_preisa()
        words = np.zeros(res.n // 32 + 1, np.uint32)
        np.bitwise_or.at(words, pr_ranks >> 5,
                         np.uint32(1) << (pr_ranks & 31).astype(np.uint32))
        bitw = torch.from_numpy(words.view(np.int32)).to(dev)
        del words
        r_all = torch.from_numpy(want_ranks).to(dev)
        cap = 2 * (int(prate) + 512)
        (kr, ks_), sel_ms = timed(lambda: lw.select_walk(focc, bitw, r_all,
                                                         cap), reps=3)
        sel_steps = int(ks_.sum())
        r_cut = r_all[::64].contiguous()
        kr_c, ks_c = lw.select_walk(focc, bitw, r_cut, SELECT_CUT)
        (pr_, ps_), sel_plain_ms = timed(lambda: lw.select_walk_plain(
            focc, bitw, r_cut, SELECT_CUT), warm=False)
        sel_err = max(max_err(kr_c, pr_), max_err(ks_c, ps_))
        # the function: each step an LF step and a test of its rank's
        # bit (the summary is this design's, not the function's); the
        # data decide the steps
        sel_bound, sel_by = bound(
            nbytes(focc.rows, bitw) + len(r_all) * 16,
            (sel_steps + len(r_all)) * (LF_STEP_OPS["sector"] + 5))
        say("kernel lf_walk select visit, %s (n=%d, %d lanes, %d steps, %d "
            "at most): max_abs_err %d, kernel %.3f ms (%.2f G steps/s), "
            "plain %.3f ms on %d lanes of %d steps at most, bound %.3f ms "
            "(%s) [%s]"
            % (label, res.n, len(r_all), sel_steps, int(ks_.max()), sel_err,
               sel_ms, sel_steps / sel_ms / 1e6, sel_plain_ms, len(r_cut),
               SELECT_CUT, sel_bound, sel_by, smi))
        if sel_err or int(ks_.min()) < 0:
            raise AssertionError("the select visit disagrees with its plain "
                                 "version")
        rec = {"max_abs_err": sel_err, "ms": sel_ms,
               "plain_ms": sel_plain_ms, "lanes": len(r_all),
               "steps": sel_steps, "bound_ms": sel_bound,
               "bound_by": sel_by, "forms": {"select": sel_ms},
               "plain_on": {"lanes": len(r_cut),
                            "steps_at_most": SELECT_CUT}}
        if sweep:
            rec["sweep"] = select_sweep(focc, bitw, r_all, cap, kr, ks_,
                                        res.n, len(pr_ranks), label)
        return {"sector": rec}

    def host_memory(label):
        """This process's peak RSS so far and ``free -g``, printed."""
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        free = subprocess.run(["free", "-g"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        say("host memory after %s: peak RSS of this process so far %.3f GiB; "
            "free -g:\n%s" % (label, rss, free))
        return rss

    # the gap chain against its plain version on a level's lanes
    def mk_args(level, focc, kd, st):
        return (focc, level.text_dev, level.gt_dev, level.c_first,
                level.table, kd, st)

    def level_buffers(level, focc):
        word = torch.int64 if is_wide(focc) else torch.int32
        gap = torch.empty(focc.n + 1, dtype=word, device=dev)
        samp = torch.empty(level._nsamp, dtype=word, device=dev)

        def clear():
            gap.zero_()
            samp.fill_(-1)

        return gap, samp, clear

    def level_compare(level, foccs, lanes, reps, warm_plain, label, lb=64,
                      sample=None):
        """``bwt_gap_chain_mk`` (or, on wide rows, its 64-bit form) against
        its plain version on the lanes (kid, starts, seeds, lens) of
        ``level`` (a ``BatchedGapRunner``): the recording form, then the
        anchor form over ``lb`` steps from each merge's rank 0 and from
        its top, per rank-row layout in ``foccs`` (more than one only for
        a level of one merge, whose rank base is 0 on every layout).
        Where ``level`` has computed its own histogram and samples on that
        layout, the kernel's are held to them too.  ``sample`` = (lanes,
        steps): the recording form's plain version runs on that many
        lanes spread over the level, each cut to that many steps, and the
        kernel on the same cut lanes (its time on every lane is ``ms``).
        Returns {layout: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
        forms, steps, lanes}}, the times summed over the three launches."""
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
        if sample:
            pick = np.linspace(0, len(kid) - 1, sample[0]).astype(np.int64)
            s_lanes = level._lanes(kid[pick], starts[pick], seeds[pick],
                                   np.minimum(lens[pick], sample[1]))
        out = {}
        for layout, focc in foccs.items():
            say_l = "%s %s rows%s," % (label, layout,
                                       " (64-bit form)" if is_wide(focc)
                                       else "")
            step_ops = chain_step_ops(focc, layout)
            tb = level.text_dev.element_size()
            args = mk_args(level, focc, kd, st)
            gap, samp, clear = level_buffers(level, focc)
            fk, k_ms = timed(lambda: gb.chain_walk_mk(*args, sd, ln, gap,
                                                      samp, rate),
                             reps=reps, setup=clear)
            if cells_total(gap) != left:
                raise AssertionError("gap total %d != left blocks %d"
                                     % (cells_total(gap), left))
            errs = []
            if focc is level.focc and level.gap is not None:
                errs.append(max(max_err(gap, level.gap),
                                max_err(samp, level._samp)))
            if sample:
                # the plain version on the cut lanes, the kernel on the same
                s_args = mk_args(level, focc, s_lanes[0], s_lanes[1])
                fk, _ms = timed(lambda: gb.chain_walk_mk(
                    *s_args, s_lanes[2], s_lanes[3], gap, samp, rate),
                    setup=clear)
                ref_gap, ref_samp = gap.clone(), samp.clone()
                fp, p_ms = timed(lambda: gb.gap_chain_mk_plain(
                    *s_args, s_lanes[2], s_lanes[3], gap, samp, rate),
                    warm=False, setup=clear)
            else:
                ref_gap, ref_samp = gap.clone(), samp.clone()
                fp, p_ms = timed(lambda: gb.gap_chain_mk_plain(
                    *args, sd, ln, gap, samp, rate), warm=warm_plain,
                    setup=clear)
            errs.append(max(max_err(fk, fp), max_err(gap, ref_gap),
                            max_err(samp, ref_samp)))
            # each input read once, each output written once
            wb = 8 if is_wide(focc) else 4
            nb = (rows_bytes(focc) + nbytes(level.table, level.c_first)
                  + tb * steps + steps // 8 + len(st) * (4 + 8 + 2 * wb + 4)
                  + gap.element_size() * gap.numel()
                  + samp.element_size() * samp.numel())
            b_ms, b_by = bound(nb, steps * step_ops)
            forms = {"recording": k_ms}
            kt, pt = k_ms, p_ms
            say("kernel gap_chain_mk %s chain form (%d steps): max_abs_err "
                "%d, kernel %.3f ms (%.2f G steps/s), plain %.3f ms%s, bound "
                "%.3f ms (%s)" % (say_l, steps, max(errs), k_ms,
                                  steps / k_ms / 1e6, p_ms,
                                  " on %d lanes of %d steps at most"
                                  % tuple(sample) if sample else "",
                                  b_ms, b_by))
            del ref_gap, ref_samp, gap, samp, fk, fp
            for which, r0s in (("from rank 0", bases),
                               ("from the top", tops)):
                a_sd = chain_words(focc, r0s)
                a_args = (*mk_args(level, focc, kd, a_st), a_sd, a_ln)
                k, k_ms = timed(lambda: gb.anchor_walk_mk(*a_args),
                                reps=reps)
                p_, p_ms = timed(lambda: gb.gap_chain_mk_plain(*a_args),
                                 warm=warm_plain)
                errs.append(max_err(k, p_))
                ab_ms, _by = bound(
                    rows_bytes(focc) + nbytes(level.table, level.c_first)
                    + lb * len(st) * (8 * tb + 1) // 8
                    + len(st) * (16 + 2 * wb),
                    lb * len(st) * step_ops)
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
            if sample:
                out[layout]["plain_on"] = {"lanes": sample[0],
                                           "steps_at_most": sample[1]}
        return out

    def widened_level(level):
        """A level of one merge as the runner's wide mode takes it: the
        same lanes and gt bits, its rows widened, c_first and the merge
        table as int64."""
        w = copy.copy(level)
        w.wide, w.focc = True, widened(level.focc)
        w.c_first = gb.word_values(level.focc, level.c_first)
        w.table = gb.word_values(level.focc, level.table)
        return w

    def replay_level(level, label):
        """``bwt_gap_chain_mk`` against its plain version on the lanes of
        ``level``, a runner right after its own ``compute()`` inside a
        build (the plain version on a sample of lanes), and, for a narrow
        level of one merge, the 64-bit form on the same lanes over the
        same rows widened, whose histogram and samples must equal the
        level's own.  Launches not counted.  Returns (record, record of
        the 64-bit form or None)."""
        name = ("%s, level of %d merge(s), %d ranks:"
                % (label, len(level.specs), level.focc.n))
        lanes = level_lanes(level)
        with uncounted():
            rec = level_compare(level, {level.focc.LAYOUT: level.focc}, lanes,
                                3, False, name, sample=PLAIN_SAMPLE)
            rec = next(iter(rec.values()))
            rec["in_build_recording_ms"] = level.chain_ms
            if len(level.specs) > 1 or level.wide:
                return rec, None
            wl = widened_level(level)
            rec_w = next(iter(level_compare(
                wl, {wl.focc.LAYOUT: wl.focc}, lanes, 3, False, name,
                sample=PLAIN_SAMPLE).values()))
        rec_w["narrow_form_ms"] = rec["ms"]
        say("gap_chain_mk %s 64-bit form %.3f ms (recording %.3f), narrow "
            "form %.3f ms (recording %.3f): %.3f x [%s]"
            % (name, rec_w["ms"], rec_w["forms"]["recording"], rec["ms"],
               rec["forms"]["recording"], rec_w["ms"] / rec["ms"], smi))
        return rec, rec_w

    def human_path(n, mem, hostmem, bwtonly, checks):
        """The flagship: a text of a human genome's length, from
        ``--seed``, built by ``compute_bwt`` (24 blocks of 2^27 at mem=2G:
        levels of 12, 6 and 3 merges); ``check_bwt`` of the result it
        returns, in the same process (the hand-off: no decode).  With
        ``checks == "full"``: every level of the build held to the plain
        version right after its own chains (``replay_level``; its time,
        device time and memory are left out of the build's), bwtcomputessa
        at rate 32 / 262144 held to the .preisa, ``select_ssa`` of 2^20
        ranks held to the .sa (below 2^32 symbols), checkbwt in a fresh
        process from .bwt (``--only human`` only), then the verify,
        harvest and select walks
        against their plain versions on a sample of lanes (the first two
        also through the 64-bit form on the same rows widened).  Returns
        what the report needs."""
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        inph = os.path.join(WORK, "human.bin")
        text, waited = take_text("human.bin", inph)
        say("input: n=%d ACGT with 1000 mutated repeats, made by a process "
            "of its own during the earlier steps (%.2f s waited for it)"
            % (n, waited))
        bwth = inph + ".bwt"
        label = "human-genome path"
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = ["bwtb3m", "inputtype=bytestream", "bwtonly=%d" % bwtonly,
                "sasamplingrate=32", "isasamplingrate=262144", "device=cuda",
                "mem=%d" % mem, "hostmem=%d" % hostmem, inph]
        built, levels, levels_w, peaks = [], [], [], []
        orig_compute = gb.BatchedGapRunner.compute

        def spy_compute(self, *a, **k):
            orig_compute(self, *a, **k)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            t0 = time.monotonic()
            # run_tool holds the build's stdout; the replay's lines are ours
            with contextlib.redirect_stdout(sys.__stdout__):
                rec, rec_w = replay_level(self, "human-genome build")
            levels.append(rec)
            if rec_w:
                levels_w.append(rec_w)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()    # the replay's buffers
            run_tool.replay_s += time.monotonic() - t0

        def build():
            if checks == "full":
                gb.BatchedGapRunner.compute = spy_compute
            try:
                built.append(compute_bwt(BwtOptions.from_arginfo(
                    ArgInfo(argv[1:], progname="bwtb3m"))))
            finally:
                gb.BatchedGapRunner.compute = orig_compute
            return 0

        rc, _, phases = run_tool("bwtb3m bwtonly=%d (%s, compute_bwt)"
                                 % (bwtonly, label), argv, fn=build,
                                 profile=checks != "full")
        if rc != 0:
            raise AssertionError("bwtb3m failed on the " + label)
        nlevels = 0
        for ln in run_tool.log.splitlines():
            if "batched level: " in ln or "pair merge: " in ln:
                nlevels += 1
                say("human-genome build, %s [%s]"
                    % (ln.split("] ", 1)[-1], smi))
        out = {"n": n, "phases": phases, "rss_gib": host_memory("the build"),
               "peak_build": max(peaks + [torch.cuda.max_memory_allocated()])}
        if checks == "full":
            if len(levels) != nlevels:
                raise AssertionError("replayed %d levels of the %d the build "
                                     "ran" % (len(levels), nlevels))
            out["levels"], out["levels_w"] = levels, levels_w
            out["replay_s"] = run_tool.replay_s
            say("human-genome build: %d levels (%s merges) held to the plain "
                "version inside the build, %.3f s left out of its wall"
                % (len(levels), " ".join(str(r["merges"]) for r in levels),
                   run_tool.replay_s))
        rc, _, _ = run_tool(
            "check_bwt of the build's result (%s, hand-off)" % label, [],
            fn=lambda: 0 if check_bwt(built[0], text, device="cuda",
                                      log=VerboseLog(1)) else 1)
        # with bwtonly=0 the build's own SA/ISA walk took the hand-off and
        # left its rows in the memo, which check_bwt then reads: no decode
        # either way
        if rc != 0 or "decode" in run_tool.log or (
                bwtonly and "hand-off" not in run_tool.log):
            raise AssertionError("check_bwt of the build's own result failed, "
                                 "or decoded the .bwt")
        del built[:]
        if checks == "full":
            if bwtonly:
                rc, _, _ = run_tool("bwtcomputessa (%s)" % label, [
                    "bwtcomputessa", "sasamplingrate=32",
                    "isasamplingrate=262144", "device=cuda", bwth])
                if rc != 0:
                    raise AssertionError("bwtcomputessa failed on the " + label)
            ssa_agrees_with_preisa(bwth, "human-genome build")
            want = select_agrees_with_sa(bwth, args.seed + 14) \
                if n < 1 << 32 else None
        out["peak"] = max(out["peak_build"], torch.cuda.max_memory_allocated())
        path_counts[label] = counts()
        say("%s launches: %s" % (label, path_counts[label]))
        need = ("lf_walk", "gap_chain_mk") + (
            ("lf_walk_select",) if checks == "full" and n < 1 << 32 else ())
        if n >= 1 << 32:
            need = ("lf_walk_w", "gap_chain_mk", "gap_chain_mk_w")
        if min(path_counts[label][k] for k in need) < 1:
            raise AssertionError("the %s did not launch %s" % (label, need))
        if checks != "full":
            return out
        # checkbwt in a fresh process at this size (62-89 s) only in the
        # runs by hand (--only human): the default run keeps its time
        # under the limit with the genome and alphabet paths' fresh checks
        if args.only == "human":
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "bwtb3m_tpu_torch", "checkbwt",
                 "inputtype=bytestream", "device=cuda", inph, bwth],
                cwd=REPO, capture_output=True, text=True, timeout=900)
            sys.stderr.write(proc.stderr)
            out["fresh_checkbwt_s"] = time.monotonic() - t0
            say("checkbwt (%s, fresh process, from .bwt): exit %d, wall %.3f "
                "s with the interpreter's start, its peak RSS %.3f GiB | %s "
                "[%s]" % (label, proc.returncode, out["fresh_checkbwt_s"],
                          resource.getrusage(resource.RUSAGE_CHILDREN)
                          .ru_maxrss / 2 ** 20, proc.stdout.strip(), smi))
            if proc.returncode != 0 or "gok=1" not in proc.stdout \
                    or "decode" not in proc.stderr:
                raise AssertionError("checkbwt in a fresh process did not "
                                     "print gok=1 from the file")
        if want is not None:
            out["select"] = select_compare(bwth, want, label)
        out["lf"] = lf_compare(bwth, text, label, ("sector", "sector_w")
                               if n < 1 << 32 else ("sector",),
                               ("verify_walk", "harvest_walk"),
                               wide=n >= 1 << 32, sample=PLAIN_SAMPLE)
        out["lf_w"] = out["lf"].pop("sector_w", None)
        return out

    # ---- 13. alphabets past 256 symbols (wavelet rows) -----------------
    def wm_lf_compare(wm, t16, ranks, positions, seg, label, sample=None,
                      forms=("lf_walk", "verify_walk", "harvest_walk")):
        """``bwt_lf_walk_wm`` (final rank, verify, harvest) against its
        plain version on the lanes (ranks, positions, segment lengths)
        that checkbwt and bwtcomputessa give it; ``sample`` = (lanes,
        steps): the plain version on that many lanes spread over the
        seeds, each cut to that many steps, the kernel on the same cut
        lanes (its time on every lane is ``ms``).  Returns {max_abs_err,
        ms, plain_ms, bound_ms, bound_by, forms}; ms, plain_ms and
        bound_ms summed over the forms the tools launch (verify +
        harvest)."""
        n, T = wm.n, len(ranks)
        steps, total = int(seg.max()), int(seg.sum())
        step_ops = WM_LEVEL_OPS["walk"] * wm.levels + WM_STEP_OPS["walk"]

        def lanes_of(rk, ps, sl):
            return [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                    for a in (rk, ps, sl)]

        full = cut = lanes_of(ranks, positions, seg)
        if sample:
            pick = np.linspace(0, T - 1, sample[0]).astype(np.int64)
            cut = lanes_of(ranks[pick], positions[pick],
                           np.minimum(seg[pick], sample[1]))

        def runs(lanes):
            r0, p0, sl = lanes
            st = int(sl.max())
            return {
                "lf_walk": (lambda: lw.lf_walk(wm, r0, st),
                            lambda: lw.lf_walk_plain(wm, r0, st)),
                "verify_walk": (
                    lambda: lw.verify_walk(wm, t16, r0, p0, sl),
                    lambda: lw.verify_walk_plain(wm, t16, r0, p0, sl)),
                "harvest_walk": (
                    lambda: torch.cat(lw.harvest_walk(wm, r0, p0, sl, 32,
                                                      262144)),
                    lambda: torch.cat(lw.harvest_walk_plain(
                        wm, r0, p0, sl, 32, 262144)))}

        # each input read once, each output written once; the steps the
        # data ask for
        rows = rows_bytes(wm)
        work = {"lf_walk": (rows + 12 * T, T * steps),
                "verify_walk": (rows + nbytes(t16) + 24 * T, total),
                "harvest_walk": (rows + 20 * T + 4 * (-(-n // 32)
                                                      + -(-n // 262144)),
                                 total)}
        out = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "operations", "forms": {}, "lanes": T,
               "levels": wm.levels, "bits_per_level": wr.DIGIT_BITS,
               "sigma": wm.sigma, "n": n}
        if sample:
            out["plain_on"] = {"lanes": sample[0],
                               "steps_at_most": sample[1]}
        for name in forms:
            _k, k_ms = timed(runs(full)[name][0], reps=3)
            kern, plain = runs(cut)[name]
            k = kern()
            p, p_ms = timed(plain, warm=False)
            err = max_err(k, p)
            nb, nsteps = work[name]
            b_ms, b_by = bound(nb, nsteps * step_ops)
            say("kernel %-12s %s, wavelet rows (n=%d, sigma=%d, %d levels "
                "of %d bits, %d lanes, %d steps max): max_abs_err %d, kernel "
                "%.3f ms (%.2f G steps/s, %.2f G blocks/s), plain %.3f ms%s, "
                "bound %.3f ms (%s) [%s]"
                % (name, label, n, wm.sigma, wm.levels, wr.DIGIT_BITS,
                   T, steps, err, k_ms,
                   nsteps / k_ms / 1e6, nsteps * wm.levels / k_ms / 1e6,
                   p_ms, " on %d lanes of %d steps at most" % tuple(sample)
                   if sample else "", b_ms, b_by, smi))
            if err:
                raise AssertionError("%s disagrees with its plain version "
                                     "on the %s" % (name, label))
            out["forms"][name] = {"ms": k_ms, "plain_ms": p_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "steps": nsteps}
            if name != "lf_walk":
                out["ms"] += k_ms
                out["plain_ms"] += p_ms
                out["bound_ms"] += b_ms
                out["bound_by"] = b_by
        return out

    def wm_merge(text_ids, sigma, s, m, e, rate, label, sample=None):
        """The merge of [s, m) into [m, e) of a text of dense ids as the
        engine runs it (``merge_runner``), and ``bwt_gap_chain_mk_wm``
        against its plain version on its lanes (``level_compare``);
        returns (record, level, right block)."""
        level, lanes, right = merge_runner(merge_scaled, text_ids, sigma,
                                           s, m, e, rate, dev)
        rec = level_compare(level, {"wavelet": level.focc}, lanes, 3, False,
                            "%s (left %d, right %d ranks, %d lanes):"
                            % (label, m - s, e - m, len(lanes[0])),
                            sample=sample)["wavelet"]
        rec["levels"] = level.focc.levels
        rec["bits_per_level"] = wr.DIGIT_BITS
        return rec, level, right

    def wm_names(sigma):
        """The kernels line's names of the forms over wavelet rows of a
        dense alphabet of ``sigma`` symbols: the uint16 forms up to 65,536
        symbols, the uint32 ones past them."""
        tail = "" if sigma <= wr.U16_SYMBOLS else "32"
        return "lf_walk_wm" + tail, "gap_chain_mk_wm" + tail

    def alphabet_2_22(sigma):
        """The forms over wavelet rows against their plain versions at 2^22
        symbols over ``sigma`` dense symbols (``wavelet_case_2_22``): the
        walk's three forms on 131,072 lanes, the chain's recording and
        anchor forms on a merge of two halves, whose histogram must also be
        the sort's; past 65,536 symbols (the uint32 forms, which no step
        3c case reaches) also the locate and decode visits at rate 32
        (``visits_2_22``)."""
        t0 = time.monotonic()
        text, isa, bwt, lanes = wavelet_case_2_22(sigma, args.seed, dev)
        n = len(text)
        wm = wr.build_wavelet_host(bwt, sigma, dev)
        t_ids = wr.as_symbols(torch.from_numpy(text.astype(np.int64)).to(dev),
                              sigma)
        walk, chain = wm_names(sigma)
        out = {walk: wm_lf_compare(wm, t_ids, *lanes,
                                   "2^22, sigma %d" % sigma)}
        if sigma > 1 << 16:
            sa = np.empty(n, np.int64)
            sa[isa] = np.arange(n)
            out["visits"] = visits_2_22(wm, sa, isa, t_ids,
                                        "sigma %d" % sigma, rates=(32,))
            del sa
        del wm, t_ids
        m = n // 2
        rec, level, _right = wm_merge(text, sigma, 0, m, n, 64,
                                      "%s 2^22, sigma %d" % (chain, sigma))
        level.compute()
        R = np.searchsorted(np.sort(isa[m:]), isa[:m])
        if not np.array_equal(level.gap.cpu().numpy(),
                              np.bincount(R, minlength=n - m + 1)):
            raise AssertionError("the chain over wavelet rows disagrees with "
                                 "the sort at sigma %d" % sigma)
        out[chain] = rec
        say("alphabet 2^22, sigma %d (%d levels): %.3f s"
            % (sigma, rec["levels"], time.monotonic() - t0))
        return out

    def code_point_path(inp, codes, n, mem, key):
        """One code-point build of step 13 (module docstring) and its
        tools on the card, its launches counted as ``path_counts[key]``:
        ``bwtb3m inputtype=utf-8 bwtonly=1``, ``bwtcomputessa`` held to
        the ``.preisa``, ``hwtPreIsaToIsa`` (the same ``.isa``),
        ``bwttestdecodespeed``, ``select_ssa`` of 2^20 ranks held to the
        ``.sa`` and SA[LF(r)] == SA[r] - 1, ``bwtdecodeblock`` of 2^20
        symbols held to the text; then, uncounted, the walk's verify and
        harvest forms on the tools' lanes over the build's rows, the
        locate visit of the select and the root merge's chain against
        their plain versions (sampled).  Returns (record, the checkbwt of
        ``.bwt`` in a fresh process, started: the caller finishes it)."""
        out = {"phases": {}}
        bwt = inp + ".bwt"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, _, out["phases"] = run_tool("bwtb3m (%s)" % key, [
            "bwtb3m", "inputtype=utf-8", "bwtonly=1", "device=cuda",
            "mem=%d" % mem, inp])
        if rc != 0 or "chains" not in out["phases"]:
            raise AssertionError("bwtb3m failed or did not take the merge "
                                 "engine on the %s" % key)
        out["build_s"] = run_tool.wall
        out["peak_build"] = torch.cuda.max_memory_allocated()
        rc, _, _ = run_tool("bwtcomputessa (%s)" % key, [
            "bwtcomputessa", "sasamplingrate=32", "isasamplingrate=262144",
            "device=cuda", bwt])
        if rc != 0:
            raise AssertionError("bwtcomputessa failed on the %s" % key)
        prate = ssa_agrees_with_preisa(bwt, key)
        isa_ref = inp + ".ssa.isa"
        shutil.copy(inp + ".isa", isa_ref)
        rc, _, _ = run_tool("hwtPreIsaToIsa (%s)" % key, [
            "hwtPreIsaToIsa", "isasamplingrate=262144", "device=cuda", bwt])
        if rc != 0 or open(inp + ".isa", "rb").read() != \
                open(isa_ref, "rb").read():
            raise AssertionError("hwtPreIsaToIsa's .isa differs from "
                                 "bwtcomputessa's on the %s" % key)
        rc, _, _ = run_tool("bwttestdecodespeed (%s)" % key, [
            "bwttestdecodespeed", "device=cuda", bwt])
        if rc != 0 or run_tool.log.count("LF-steps/s") != 5:
            raise AssertionError("bwttestdecodespeed failed")
        # select_ssa past 256 symbols: FMIndex.locate_batch, the locate
        # visit over the wavelet rows, on the .sa of bwtcomputessa
        register_samples(bwt)
        _r, sa_a = load_sampled_array(inp + ".sa")
        want_a = seeded_ranks(n, len(sa_a), args.seed + 18)
        half = len(want_a) // 2
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = select_ssa(bwt, want_a, device=dev)
        out["select_s"] = time.monotonic() - t0
        if not np.array_equal(got[half:], sa_a[want_a[half:] // 32]):
            raise AssertionError("select_ssa past 256 symbols disagrees with "
                                 "the .sa on the %s" % key)
        wm, _symmap = BwtResult.load(bwt).load_wavelet(dev)
        _sym, lf_r = wr.lf_step(wm, torch.from_numpy(want_a).to(dev))
        del wm
        t0 = time.monotonic()
        got_lf = select_ssa(bwt, lf_r.cpu().numpy(), device=dev)
        out["select_lf_s"] = time.monotonic() - t0
        if not np.array_equal(got_lf, (got - 1) % n):
            raise AssertionError("SA[LF(r)] != SA[r] - 1 on the %s" % key)
        say("select_ssa, %s (the locate visit over wavelet rows): 2^20 "
            "ranks in %.3f s, == the .sa at the 2^19 sampled ranks; at their "
            "LF ranks %.3f s, SA[LF(r)] == (SA[r] - 1) mod n for every rank "
            "[%s]" % (key, out["select_s"], out["select_lf_s"], smi))
        # bwtdecodeblock of 2^20 symbols from a seeded place, held to the
        # code points by the tool itself (ref=)
        low = int(np.random.default_rng(args.seed + 20).integers(0, n))
        rc, _, _ = run_tool("bwtdecodeblock (%s, 2^20 symbols)" % key, [
            "bwtdecodeblock", "inputtype=utf-8", "ref=" + inp, "device=cuda",
            bwt, str(low), str(1 << 20)])
        if rc != 0:
            raise AssertionError("bwtdecodeblock failed or differs from the "
                                 "text on the %s" % key)
        path_counts[key] = counts()
        out["peak"] = torch.cuda.max_memory_allocated()
        say("%s launches: %s" % (key, path_counts[key]))
        res = BwtResult.load(bwt)
        wm, symmap = res.load_wavelet(dev)
        walk, chain = wm_names(wm.sigma)
        if min(path_counts[key][k] for k in (walk, chain, "lf_walk_locate",
                                             "lf_walk_decode")) < 1:
            raise AssertionError("the %s did not launch the kernels over "
                                 "wavelet rows" % key)
        out["wavelet_bytes"] = wm.nbytes()
        out["occtable_bytes"] = wr.occtable_bytes(n, wm.sigma)
        out["sigma"], out["levels"] = wm.sigma, wm.levels
        say("rank rows of the %s: wavelet rows %d bytes (%d levels of %d "
            "bits, %d 64-byte blocks each), the reference's OccTable layout "
            "would need %d bytes (%.1f x) [%s]"
            % (key, out["wavelet_bytes"], wm.levels, wr.DIGIT_BITS, wm.nblk,
               out["occtable_bytes"],
               out["occtable_bytes"] / out["wavelet_bytes"], smi))
        # the kernels at the path's shapes: the tools' lanes over the
        # path's own rows, the select's locate visit, the root merge's chain
        dense = dense_ids(symmap, codes)
        ranks, positions, _r = res.load_preisa()
        ranks, positions, seg = seed_segments(ranks, positions, n)
        t_ids = wr.as_symbols(torch.from_numpy(
            dense.view(np.int16 if dense.dtype == np.uint16 else np.int32))
            .to(dev), wm.sigma)
        with uncounted():
            out["lf"] = wm_lf_compare(wm, t_ids, ranks, positions, seg, key,
                                      sample=PLAIN_SAMPLE,
                                      forms=("verify_walk", "harvest_walk"))
        out["locate"] = locate_record(wm, torch.from_numpy(want_a).to(dev),
                                      32, key, PLAIN_SAMPLE[0])
        del t_ids, wm
        opts = BwtOptions(input_path=inp, mem=mem, device="cuda")
        blocks = merge_scaled._plan_blocks_fixed(n, opts.max_block_symbols)
        if len(blocks) < 2:
            raise AssertionError("the %s's build is one block" % key)
        # the root merges [0, m) with the tree's right part [m, n): with
        # three blocks the carried last block
        m_r = blocks[1 << ((len(blocks) - 1).bit_length() - 1)][0]
        with uncounted():
            out["chain"], level, _right = wm_merge(
                dense, len(symmap), 0, m_r, n, prate,
                "%s root merge, %s" % (chain, key), sample=PLAIN_SAMPLE)
        del level, _right, dense
        torch.cuda.empty_cache()
        return out, start_checkbwt(inp, bwt, "utf-8")

    def alphabet_path(n, mem, n32, mem32):
        """The path of alphabets past 256 symbols (module docstring, step
        13); returns its record."""
        out = {}
        with uncounted():
            out["2^22"] = {s: alphabet_2_22(s) for s in ALPHABET_2_22}
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        fresh32 = None
        if n32:
            inp32 = os.path.join(WORK, "cjk.txt")
            codes32, waited = take_text("cjk.txt.u32", inp32 + ".u32",
                                        np.uint32)
            os.replace(os.path.join(TEXTS, "cjk.txt"), inp32)
            say("input past 65,536 symbols: n=%d code points over %d symbols "
                "(Zipf s=1.0 over the CJK Unified Ideographs, Hangul, CJK "
                "Extensions A-G; 1000 mutated repeats), %d bytes of UTF-8, "
                "made by the text writer (waited %.2f s)"
                % (n32, len(cjk_pool()), os.path.getsize(inp32), waited))
            out["32"], fresh32 = code_point_path(inp32, codes32, n32, mem32,
                                                 "alphabet32 path")
            del codes32
        inp = os.path.join(WORK, "corpus.txt")
        t0 = time.monotonic()
        codes = utf8_corpus(n, args.seed + 13, device=dev)
        size = write_utf8(inp, codes)
        say("input: n=%d code points over 5000 symbols (Zipf s=1.0 over "
            "ASCII, Latin, Greek, Cyrillic, CJK; 1000 mutated repeats), "
            "%d bytes of UTF-8, made in %.2f s (host)"
            % (n, size, time.monotonic() - t0))
        out["16"], fresh = code_point_path(inp, codes, n, mem,
                                           "alphabet path")
        del codes
        if fresh32:
            out["32"]["fresh_checkbwt_s"] = finish_checkbwt(
                fresh32, "alphabet32 path", ", beside the 5,000-symbol build",
                "wavelet rows")
        # bwtcodec=rlh, bwtonly=0 at 16,777,259: engine=merge against
        # engine=doubling, every file equal, then checkbwt of the RLH1 file
        n2 = 16_777_259
        inp2 = os.path.join(WORK, "corpus16m.txt")
        write_utf8(inp2, utf8_corpus(n2, args.seed + 14, device=dev))
        outs = {}
        for eng, extra in (("merge", ["mem=67108864", "bwtonly=0"]),
                           ("doubling", ["bwtonly=1"])):
            outs[eng] = os.path.join(WORK, "c16m_%s.bwt" % eng)
            # their walls are reported, not their device time: the
            # profiler's summary of the merge build alone took 6 s
            rc, _, _ = run_tool("bwtb3m bwtcodec=rlh engine=%s n=%d" % (eng,
                                                                        n2), [
                "bwtb3m", "inputtype=utf-8", "bwtcodec=rlh", "device=cuda",
                "engine=" + eng, "outputfilename=" + outs[eng], *extra,
                inp2], profile=False)
            if rc != 0:
                raise AssertionError("bwtb3m bwtcodec=rlh engine=%s failed"
                                     % eng)
        ssa_agrees_with_preisa(outs["merge"], "RLH1 merge build")
        for ext in ("bwt", "hist", "preisa"):
            a, b = (open(outs[e][:-4] + "." + ext, "rb").read()
                    for e in ("merge", "doubling"))
            if a != b:
                raise AssertionError(".%s of engine=merge differs from "
                                     "engine=doubling (RLH, utf-8)" % ext)
        if open(outs["merge"], "rb").read(4) != b"RLH1":
            raise AssertionError("bwtcodec=rlh did not write an RLH1 file")
        rc, o, _ = run_tool("checkbwt (RLH1, n=%d)" % n2, [
            "checkbwt", "inputtype=utf-8", "device=cuda", inp2,
            outs["merge"]])
        if rc != 0 or "gok=1" not in o:
            raise AssertionError("checkbwt of the RLH1 build failed")
        say("bwtcodec=rlh, n=%d over 5000 symbols: engine=merge "
            "(mem=67108864, bwtonly=0: .sa .isa .hwt written, the samples "
            "agree with the .preisa) == engine=doubling, .bwt .hist .preisa "
            "byte-identical; checkbwt gok=1 on the RLH1 file" % n2)
        out["16"]["fresh_checkbwt_s"] = finish_checkbwt(
            fresh, "alphabet path", ", beside the RLH builds",
            "wavelet rows")
        shutil.rmtree(WORK, ignore_errors=True)
        return out

    def alphabet_kernels(alpha):
        """The kernels line's rows of the forms over wavelet rows: each
        code-point build's shapes (its tools' verify + harvest walks, its
        root merge's chain), with the 2^22 cases of the same form beside
        them."""
        rows = []
        for sub in ("16", "32"):
            path = alpha.get(sub)
            if path is None:
                continue
            for name, main in zip(wm_names(path["sigma"]),
                                  (path["lf"], path["chain"])):
                cases = {str(s): c[name] for s, c in alpha["2^22"].items()
                         if name in c}
                rows.append({
                    "name": name, "route": "cuda",
                    "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                    "launches": path_counts[ROW_PATH[name]][name],
                    "shapes_of": ROW_PATH[name],
                    "launches_by_path": {p: c[name]
                                         for p, c in path_counts.items()},
                    "max_abs_err": max(errors_in([main, cases])),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "plain_on": main.get("plain_on"),
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": None, "layout": "wavelet",
                    "sigma": path["sigma"], "levels": main["levels"],
                    "bits_per_level": main["bits_per_level"],
                    "forms": main["forms"], "sigma_2^22": cases,
                    "visits_2^22": {str(s): c["visits"]
                                    for s, c in alpha["2^22"].items()
                                    if "visits" in c and name in c
                                    and name.startswith("lf_walk")}})
        return rows

    def alphabet_report(alpha):
        for sub, label in (("16", "alphabet build"),
                           ("32", "alphabet32 build")):
            path = alpha.get(sub)
            if path is None:
                continue
            for name, (wall, dev_s, _span) in sorted(
                    path["phases"].items(), key=lambda kv: -kv[1][0]):
                say("%s phase %-18s wall %.3f s, device busy %s [%s]"
                    % (label, name, wall, "%.3f s" % dev_s if dev_s
                       else "not measured", smi))
            say("peak device memory: %s (sigma %d, %d levels) %.3f GiB, "
                "path %.3f GiB; wavelet rows %.3f GiB, OccTable layout %.3f "
                "GiB [%s]"
                % (label, path["sigma"], path["levels"],
                   path["peak_build"] / 2 ** 30, path["peak"] / 2 ** 30,
                   path["wavelet_bytes"] / 2 ** 30,
                   path["occtable_bytes"] / 2 ** 30, smi))

    # ---- the FM index: the LF-walk kernel's locate and decode visits ---
    def walk_step_ops(rows):
        """Integer operations of one LF step over ``rows`` (loads
        excluded), as the kernels line counts them."""
        if is_wavelet(rows):
            return WM_LEVEL_OPS["walk"] * rows.levels + WM_STEP_OPS["walk"]
        return LF_STEP_OPS[rows.LAYOUT] + (WIDE_STEP_OPS if is_wide(rows)
                                           else 0)

    def rows_name(rows):
        return ("wide " if is_wide(rows) else "") + rows.LAYOUT

    def lane_bytes(rows):
        return 8 if is_wide(rows) else 4

    def step_bytes(rows):
        """The bytes one LF step reads: a row (32 sector, 128 bit-plane,
        the byte rows' width), or a 64-byte block on every level of the
        wavelet rows."""
        if is_wavelet(rows):
            return rows.levels * (nbytes(rows.blocks)
                                  // max(1, rows.levels * rows.nblk))
        return rows.rows.shape[1]

    def walk_bytes(rows, steps):
        """What a sparse walk of ``steps`` steps must read of the rows: each
        step's row or blocks, and no more than the rows hold."""
        return min(rows_bytes(rows), steps * step_bytes(rows))

    def locate_record(rows, r0, rate, label, sample=None, sa=None,
                      warm=True, plain_lanes=None):
        """The locate visit on lanes ``r0`` (a tensor on the card): the
        kernel timed on every lane to its end (``warm``: after one untimed
        launch); against its plain version on every lane, on ``sample``
        lanes spread over them (the kernel's answers there), or on
        ``plain_lanes`` (lanes that meet a sampled rank within a few
        steps, launched apart), each walk to its end in both; the SA it
        gives against ``sa`` (numpy) where given.  Launches not counted."""
        n, rate = rows.n, int(rate)
        with uncounted():
            (r, st), k_ms = timed(lambda: lw.locate_walk(rows, r0, rate),
                                  reps=1, warm=warm)
            if int(st.min()) < 0:
                raise AssertionError("a locate walk met no sampled rank")
            if sa is not None and not np.array_equal(
                    (sa[r.cpu().numpy()] + st.cpu().numpy()) % n,
                    sa[r0.cpu().numpy()]):
                raise AssertionError("the locate visit disagrees with the "
                                     "sort on the %s" % label)
            lanes, kr, ks, on = r0, r, st, ""
            if sample:
                pick = torch.from_numpy(np.linspace(
                    0, len(r0) - 1, sample).astype(np.int64)).to(dev)
                lanes, kr, ks = r0[pick], r[pick], st[pick]
                on = " on %d lanes" % sample
            elif plain_lanes is not None:
                lanes = plain_lanes
                kr, ks = lw.locate_walk(rows, lanes, rate)
            (pr, ps), p_ms = timed(lambda: lw.locate_walk_plain(
                rows, lanes, rate), warm=False)
        err = max(max_err(kr, pr), max_err(ks, ps))
        if plain_lanes is not None:
            on = " on %d lanes %d steps at most from a sampled rank" % (
                len(lanes), int(ps.max()))
        steps, longest = int(st.sum()), int(st.max())
        b_ms, b_by = bound(
            walk_bytes(rows, steps) + len(r0) * (2 * lane_bytes(rows) + 8),
            steps * walk_step_ops(rows) + (steps + len(r0))
            * LOCATE_VISIT_OPS)
        grid = -(-len(r0) // 256)
        say("kernel lf_walk locate visit, %s, %s rows (n=%d, rate %d, %d "
            "lanes, %d steps, mean %.2f, longest %d; grid of %d blocks x 256 "
            "threads, one a lane): max_abs_err %d, kernel %.3f ms (%.2f G "
            "steps/s), plain %.3f ms%s, bound %.3f ms (%s) [%s]"
            % (label, rows_name(rows), n, rate, len(r0), steps,
               steps / len(r0), longest, grid, err, k_ms, steps / k_ms / 1e6,
               p_ms, on, b_ms, b_by, smi))
        if err:
            raise AssertionError("the locate visit disagrees with its plain "
                                 "version on the %s" % label)
        rec = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "lanes": len(r0),
               "rate": rate, "steps": steps, "mean_steps": steps / len(r0),
               "longest": longest, "grid_blocks": grid,
               "layout": rows_name(rows)}
        if on:
            rec["plain_on"] = {"lanes": len(lanes),
                               "steps_at_most": int(ps.max())}
        return rec

    def decode_record(rows, plan, base, length, label, want=None, cut=None,
                      warm=True):
        """The decode visit of text [base, base + length) on the lanes
        (ranks, positions, segment lengths on the card) that ``plan``
        holds or, a callable, builds (``FMIndex.decode_plan``): then the
        plan and the kernel are timed together, and each alone.  The
        output against ``want`` (the dense ids as the kernel writes them)
        where given; against its plain version on the same lanes, each cut
        to ``cut`` steps where given (kernel and plain version alike).
        Launches not counted."""
        with uncounted():
            if callable(plan):
                out, ms = timed(lambda: lw.decode_walk(rows, *plan(), base,
                                                       length), reps=1,
                                warm=warm)
                (r0, p0, seg), plan_ms = timed(plan, reps=1, warm=warm)
                _out, k_ms = timed(lambda: lw.decode_walk(
                    rows, r0, p0, seg, base, length), reps=1, warm=warm)
            else:
                r0, p0, seg = plan
                out, k_ms = timed(lambda: lw.decode_walk(
                    rows, r0, p0, seg, base, length), reps=1, warm=warm)
                ms, plan_ms = k_ms, 0.0
            if want is not None and not torch.equal(out, want):
                raise AssertionError("the decode visit does not give the "
                                     "text on the %s" % label)
            sl = seg if cut is None else seg.clamp(max=cut)
            kc = out if cut is None else lw.decode_walk(rows, r0, p0, sl,
                                                        base, length)
            pc, p_ms = timed(lambda: lw.decode_walk_plain(
                rows, r0, p0, sl, base, length), warm=False)
        err = max_err(kc, pc)
        steps, longest = int(seg.sum()), int(seg.max())
        grid = -(-len(r0) // 256)
        b_ms, b_by = bound(
            walk_bytes(rows, steps) + len(r0) * (2 * lane_bytes(rows) + 4)
            + nbytes(out), steps * (walk_step_ops(rows) + DECODE_VISIT_OPS))
        say("kernel lf_walk decode visit, %s, %s rows (n=%d, %d symbols from "
            "%d, %d lanes, longest %d, %d steps; grid of %d blocks x 256 "
            "threads): max_abs_err %d, plan + kernel %.3f ms (plan %.3f ms, "
            "kernel %.3f ms, %.2f G steps/s), plain %.3f ms%s, bound %.3f ms "
            "(%s) [%s]"
            % (label, rows_name(rows), rows.n, length, base, len(r0),
               longest, steps, grid, err, ms, plan_ms, k_ms,
               steps / k_ms / 1e6, p_ms,
               " with every lane cut to %d steps" % cut if cut else "", b_ms,
               b_by, smi))
        if err:
            raise AssertionError("the decode visit disagrees with its plain "
                                 "version on the %s" % label)
        rec = {"max_abs_err": err, "ms": ms, "plan_ms": plan_ms,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": b_by, "lanes": len(r0), "longest": longest,
               "grid_blocks": grid, "symbols": length, "steps": steps,
               "layout": rows_name(rows)}
        if cut:
            rec["plain_on"] = {"lanes": len(r0), "steps_at_most": cut}
        return rec

    def dev_lanes(arrays):
        return [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in arrays]

    def visits_2_22(rows, sa, isa, text_t, label, rates=(32, 262144)):
        """Phase a on one row family at n = 2^22: the locate visit on
        131,072 seeded ranks at rate 32 and on the first
        ``LONG_LANES_2_22`` of them at rate 262,144, and the decode visit
        of the whole text at both rates, against their plain versions bit
        for bit and against the sort's SA and the text.  At 262,144 (walks
        of 10^5-10^6 steps) the kernel is timed once without a warm
        launch; the locate's plain version runs on ``SAMPLE_2_22[0]``
        lanes that the SA places 1 to 512 steps before one of the 16
        sampled ranks (ISA[SA[s] + k]), the decode's on its 16 lanes cut
        to ``SAMPLE_2_22[1]`` steps.  ``rates``: the rates to run."""
        n = rows.n
        rng = np.random.default_rng(args.seed + 17)
        r_all = torch.from_numpy(rng.integers(0, n, 131072)).to(dev)
        rec = {}
        for rate in rates:
            long = rate > 32
            near = None
            if long:
                s_pos = sa[np.arange(0, n, rate)]
                k = np.arange(1, SAMPLE_2_22[0] // len(s_pos) + 1)
                near = torch.from_numpy(isa[(s_pos[:, None] + k[None, :])
                                            .reshape(-1) % n]).to(dev)
            rec["locate %d" % rate] = locate_record(
                rows, r_all[:LONG_LANES_2_22] if long else r_all, rate,
                "%s, 2^22" % label, sa=sa, warm=not long, plain_lanes=near)
            lanes = dev_lanes(decode_lanes(SampledISA(rate, isa[::rate], n),
                                           n, 0, n))
            rec["decode %d" % rate] = decode_record(
                rows, lanes, 0, n, "%s, 2^22" % label, text_t,
                SAMPLE_2_22[1] if long else None, warm=not long)
        return rec

    RANK_ALL = {}

    def rank_all_2_22(wm):
        """``rank_all_symbols_batch`` (torch on the card, the level walk
        over the wavelet rows) at 4,096 positions: 0, n, 3,000 at and
        beside the 96-digit block edges, the rest random; against the
        per-symbol ``rank`` (a descent per symbol and position, 2^24 pairs
        a call) on the same rows, every pair."""
        n, sigma = wm.n, wm.sigma
        rng = np.random.default_rng(args.seed + 19)
        edges = (96 * rng.integers(1, n // 96, 1000))[:, None] + [-1, 0, 1]
        pos = np.concatenate([[0, n], edges.reshape(-1),
                              rng.integers(0, n + 1, 4096 - 3002)])
        i = torch.from_numpy(pos).to(dev)
        got, ms = timed(lambda: rank_all_symbols_batch(wm, i))
        cs = max(1, (1 << 24) // len(pos))

        def per_symbol():
            return torch.cat([wr.rank(wm, torch.arange(
                a, min(a + cs, sigma), device=dev).repeat(len(pos)),
                i.repeat_interleave(min(a + cs, sigma) - a)).view(
                    len(pos), -1) for a in range(0, sigma, cs)], 1)

        want, plain_ms = timed(per_symbol, warm=False)
        err = max_err(got, want)
        reads = sum(-(-sigma // wr.RADIX ** (wm.levels - l))
                    for l in range(wm.levels))
        say("rank_all_symbols_batch (torch, level walk), wavelet rows "
            "n=2^22 sigma=%d, %d positions: max_abs_err %d, %.3f ms; the "
            "per-symbol rank %.3f ms; %d block reads a position (a descent "
            "per symbol: %d) [%s]" % (sigma, len(pos), err, ms, plain_ms,
                                      reads, sigma * wm.levels, smi))
        if err or tuple(got.shape) != (len(pos), sigma):
            raise AssertionError("rank_all_symbols_batch disagrees with "
                                 "the per-symbol rank at sigma %d" % sigma)
        del got, want
        return {"max_abs_err": err, "ms": ms, "per_symbol_rank_ms": plain_ms,
                "positions": len(pos), "reads_per_position": reads}

    def index_2_22():
        """Phase a: both visits on every row family at n = 2^22: sector
        and bit-plane rows (sigma 4), bit-plane rows (sigma 7), byte rows
        (sigma 200), those four doctored as wide rows across 2^32 (the
        64-bit form), and wavelet rows over 300, 5,000 and 65,536
        symbols."""
        n = 1 << 22
        out = {}
        t_all = time.monotonic()
        for sigma, layouts in ((4, ("sector", "bitplane")), (7, ("bitplane",)),
                               (200, ("bytes",))):
            t0 = time.monotonic()
            rng = np.random.default_rng(args.seed + sigma)
            text = rng.integers(0, sigma, n).astype(np.uint8)
            sa, isa, bwt = suffix_array(text, sigma, dev)
            t_dev = torch.from_numpy(text).to(dev)
            bwt_dev = torch.from_numpy(bwt.astype(np.uint8)).to(dev)
            for layout in layouts:
                focc = build_focc_host(bwt.astype(np.uint8), sigma, dev,
                                       layout)
                out["sigma=%d %s" % (sigma, layout)] = visits_2_22(
                    focc, sa, isa, t_dev, "sigma %d" % sigma)
                del focc
                # every symbol's occ count across 2^32 halfway through
                cnt = np.bincount(bwt, minlength=sigma)
                w = pw.doctored(bwt_dev, sigma, layout, torch.from_numpy(
                    ((1 << 32) - cnt // 2).astype(np.int64)))
                out["sigma=%d %s doctored wide" % (sigma, layout)] = \
                    visits_2_22(w, sa, isa, t_dev, "sigma %d across 2^32"
                                % sigma)
                del w
            say("phase 3c, sigma %d: %.3f s" % (sigma, time.monotonic() - t0))
        for sigma in (300, 5000, 65536):
            t0 = time.monotonic()
            text, isa, bwt, _lanes = wavelet_case_2_22(sigma, args.seed, dev)
            sa = np.empty(n, np.int64)
            sa[isa] = np.arange(n)
            wm = wr.build_wavelet_host(bwt, sigma, dev)
            t_ids = wr.as_symbols(torch.from_numpy(text.astype(np.int64))
                                  .to(dev), sigma)
            out["sigma=%d wavelet" % sigma] = visits_2_22(
                wm, sa, isa, t_ids, "sigma %d" % sigma)
            if sigma > 300:
                RANK_ALL[sigma] = rank_all_2_22(wm)
            del wm, t_ids
            say("phase 3c, sigma %d: %.3f s" % (sigma, time.monotonic() - t0))
        say("phase 3c (the visits at 2^22): %.3f s" % (time.monotonic()
                                                       - t_all))
        return out

    def register_samples(bwt_file):
        """Name the .sa / .isa that bwtcomputessa wrote beside a bwtonly=1
        build in its .meta, as a bwtonly=0 build names its own: the FM
        index (and select_ssa past 256 symbols) reads the sampled SA that
        the .meta names, in both packages."""
        base = bwt_file[:-4]
        meta = formats.read_meta(base + ".meta")
        meta["files"]["sa"] = base + ".sa"
        meta["files"]["isa"] = base + ".isa"
        formats.write_meta(base + ".meta", meta)

    def seeded_ranks(n, nsa, seed):
        """2^19 ranks at random and 2^19 SA-sampled ranks (rate 32)."""
        rng = np.random.default_rng(seed)
        half = 1 << 19
        return np.concatenate([rng.integers(0, n, half),
                               32 * rng.integers(0, nsa, half)])

    def genome_index(bwt_file, inp, text, label):
        """Phase b (main path part): ``FMIndex.from_bwt_result`` over the
        build's rows, ``locate_batch`` of 2^20 seeded ranks held to
        ``select_ssa`` of the same ranks (the select kernel over the
        .preisa bitmap) and to the .sa at the sampled ones, and
        ``bwtdecodeblock ref=<text>`` of 2^24 symbols at a seeded offset
        and across the end of the text."""
        res = BwtResult.load(bwt_file)
        n = res.n
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fm = FMIndex.from_bwt_result(res, device=dev)
        t_fm = time.monotonic() - t0
        _r, sa_s = load_sampled_array(bwt_file[:-4] + ".sa")
        ranks = seeded_ranks(n, len(sa_s), args.seed + 16)
        half = len(ranks) // 2
        t0 = time.monotonic()
        pos = fm.locate_batch(ranks)
        t_loc = time.monotonic() - t0
        stats = dict(fm.last_locate)
        t0 = time.monotonic()
        sel = select_ssa(bwt_file, ranks, device=dev)
        t_sel = time.monotonic() - t0
        if not (np.array_equal(pos, sel) and np.array_equal(
                pos[half:], sa_s[ranks[half:] // 32])):
            raise AssertionError("locate_batch disagrees with select_ssa or "
                                 "the .sa on the %s" % label)
        say("FMIndex on the %s: from_bwt_result %.3f s, locate_batch of 2^20 "
            "ranks %.3f s wall (mean %.2f steps, longest %d) == select_ssa "
            "(%.3f s) and the .sa at the 2^19 sampled ranks [%s]"
            % (label, t_fm, t_loc, stats["steps"] / stats["lanes"],
               stats["longest"], t_sel, smi))
        L = 1 << 24
        rng = np.random.default_rng(args.seed + 19)
        decodes = []
        for off in (int(rng.integers(0, n - L)), n - L // 2):
            rc, _o, _p = run_tool("bwtdecodeblock (%s, 2^24 symbols from "
                                  "%d)" % (label, off), [
                "bwtdecodeblock", "ref=" + inp, "device=cuda", bwt_file,
                str(off), str(L)])
            want = np.take(text, (off + np.arange(L)) % n)
            if rc != 0 or run_tool.out_bytes != want.tobytes():
                raise AssertionError("bwtdecodeblock at %d failed on the %s"
                                     % (off, label))
            decodes.append({"offset": off, "wall_s": run_tool.wall})
        return {"fm": fm, "ranks": ranks, "locate_stats": stats,
                "locate_wall_s": t_loc, "select_wall_s": t_sel,
                "from_bwt_result_s": t_fm, "decodes": decodes, "text": text}

    def index_compare(idx, label):
        """Phase b (after the path's counts): both visits at the path's
        shapes, timed, against their plain versions on a sample."""
        fm = idx.pop("fm")
        text = idx.pop("text")
        L = 1 << 24
        r_all = torch.from_numpy(idx.pop("ranks")).to(dev)
        idx["locate"] = locate_record(fm.rows, r_all, fm.sa.rate, label,
                                      PLAIN_SAMPLE[0])
        off = idx["decodes"][0]["offset"]
        want = fm.dense_ids(np.take(text, off + np.arange(L))).to(
            torch.uint8)
        idx["decode"] = decode_record(
            fm.rows, lambda: fm.decode_plan(off, L), off, L, label, want,
            PLAIN_SAMPLE[1])
        del fm
        return idx

    def index_path(n):
        """Phase d: a chromosome-sized reference (``make_text``'s repeats),
        as a .pac: ``bwtb3m inputtype=pacterm bwtonly=0 sasamplingrate=32``;
        ``bwtb3mtobwa`` held to the .bwt and the .sa; ``allHamDna
        maxmis=2`` on 10,000 reads of 100 bp (seeded positions, either
        strand, 0-2 seeded substitutions), each read's origin among its
        lines with NM equal to its substitutions, and the search's plain
        version on 200 of them giving the same intervals in the same
        order; ``probeScanDna`` occ against
        hwt, k = 31, on 1,000 probes of 200 bp; ``bwtdecodeblock`` of 2^20
        symbols; the converters (``bwttohwt`` against the build's .hwt,
        ``hwtToRlHwt verify=1`` on the first 16,777,259 bases; on an
        ``inputtype=pac bwtonly=1`` build
        of the same codes ``bwttodnarank`` and ``bwttodnarank256``, read
        back and held to the BWT's ranks at 2^20 seeded positions)."""
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        out = {"n": n}
        t0 = time.monotonic()
        table = np.zeros(256, np.uint8)
        table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
        codes = table[make_text(n, args.seed + 20)]
        pac = os.path.join(WORK, "chrom.pac")
        write_pac(pac, codes)
        say("input: %d bases (ACGT with 1000 mutated repeats) as a .pac, "
            "made in %.2f s (host)" % (n, time.monotonic() - t0))
        bwt = pac + ".bwt"
        reset_counts()
        hamdna.FRONTIER["stepped"] = 0
        rc, _, _ = run_tool("bwtb3m inputtype=pacterm (index path)", [
            "bwtb3m", "inputtype=pacterm", "bwtonly=0", "sasamplingrate=32",
            "device=cuda", pac])
        if rc != 0:
            raise AssertionError("bwtb3m inputtype=pacterm failed")
        res = BwtResult.load(bwt)
        lap("14, bwtb3mtobwa")
        # BWA export: bases = the .bwt less its $ row, SA = the build's .sa
        rc, _, _ = run_tool("bwtb3mtobwa (index path)", [
            "bwtb3mtobwa", bwt, pac + ".bwa.bwt", pac + ".bwa.sa"])
        primary, _L2, bases = read_bwa_bwt(pac + ".bwa.bwt")
        p2, _L2b, intv, seq_len, vals = read_bwa_sa(pac + ".bwa.sa")
        full = res.load_bwt()
        _r, sa_s = load_sampled_array(res.sa_path)
        if rc != 0 or full[primary] != 0 or p2 != primary \
                or seq_len != n or intv != 32 \
                or not np.array_equal(bases, np.delete(full, primary) - 1) \
                or not np.array_equal(vals, sa_s[1:]):
            raise AssertionError("bwtb3mtobwa's files disagree with the "
                                 "build's .bwt and .sa")
        del full, bases, vals
        say("bwtb3mtobwa: BWA .bwt == the .bwt less its $ row (primary %d), "
            "BWA .sa == the build's .sa at rate 32" % primary)
        lap("14, allHamDna")
        # allHamDna on 10,000 reads of 100 bp
        rng = np.random.default_rng(args.seed + 21)
        nreads, m = 10_000, 100
        starts = rng.integers(0, n - m, nreads)
        strand = rng.integers(0, 2, nreads)
        nsub = rng.integers(0, 3, nreads)
        fa = os.path.join(WORK, "reads.fa")
        pats200 = []                   # the first 200 reads, both strands
        with open(fa, "w") as f:
            for i in range(nreads):
                seg = codes[starts[i]:starts[i] + m].astype(np.int64)
                at = rng.choice(m, nsub[i], replace=False)
                seg[at] = (seg[at] + rng.integers(1, 4, len(at))) % 4
                read = (3 - seg)[::-1] if strand[i] else seg
                f.write(">r%d\n%s\n" % (i, "".join("ACGT"[c] for c in read)))
                if i < 200:
                    pats200 += [read, (3 - read)[::-1]]
        # no profiler: the summary of the search's 10^5 small kernels
        # took 76 s on the host of an H100 machine, for 5.6 s of tool
        rc, sam, _ = run_tool("allHamDna maxmis=2 (index path, 10,000 reads "
                              "of 100 bp)", ["allHamDna", "maxmis=2",
                                             "device=cuda", bwt, fa],
                              profile=False)
        out["allhamdna_s"] = run_tool.wall
        by_read = {}
        for ln in sam.splitlines():
            if not ln.startswith("@"):
                by_read.setdefault(ln.split("\t", 1)[0], []).append(ln)
        missing = [i for i in range(nreads) if not any(
            x.split("\t")[1] == str(16 * strand[i])
            and x.split("\t")[3] == str(starts[i] + 1)
            and "\tNM:i:%d\t" % nsub[i] in x
            for x in by_read.get("r%d" % i, []))]
        nlines = sum(len(v) for v in by_read.values())
        out["frontier"] = dict(hamdna.FRONTIER)
        say("allHamDna: %d reads, %d SAM lines, %.3f s wall (%.1f reads/s); "
            "%d states stepped; reads whose origin is missing: %d [%s]"
            % (nreads, nlines, out["allhamdna_s"],
               nreads / out["allhamdna_s"], out["frontier"]["stepped"],
               len(missing), smi))
        if rc != 0 or missing:
            raise AssertionError("allHamDna missed the origin of reads %s"
                                 % missing[:10])
        lap("14, probeScanDna")
        # probeScanDna, occ against hwt
        pstarts = rng.integers(0, n - 200, 1000)
        pfa = os.path.join(WORK, "probes.fa")
        with open(pfa, "w") as f:
            for i, a in enumerate(pstarts):
                seg = codes[a:a + 200].astype(np.int64)
                if i % 2:
                    seg[100] = (seg[100] + 1) % 4
                f.write(">p%d\n%s\n" % (i, "".join("ACGT"[c] for c in seg)))
        lines = {}
        for mode in ("occ", "hwt"):
            rc, o, _ = run_tool("probeScanDna mode=%s k=31 (index path, 1,000 "
                                "probes of 200 bp)" % mode, [
                "probeScanDna", "mode=" + mode, "k=31", "device=cuda", bwt,
                pfa], profile=False)
            lines[mode] = o
            out["probescan_%s_s" % mode] = run_tool.wall
            if rc != 0:
                raise AssertionError("probeScanDna mode=%s failed" % mode)
        if lines["occ"] != lines["hwt"] or len(lines["occ"].splitlines()) \
                != 1000:
            raise AssertionError("probeScanDna's occ and hwt lines differ")
        say("probeScanDna k=31: occ == hwt on 1,000 probes (170,000 k-mers): "
            "%.3f / %.3f s wall (%.0f / %.0f k-mers/s) [%s]"
            % (out["probescan_occ_s"], out["probescan_hwt_s"],
               170_000 / out["probescan_occ_s"],
               170_000 / out["probescan_hwt_s"], smi))
        lap("14, bwtdecodeblock")
        # bwtdecodeblock on the pacterm build (symbols 1..4)
        off = int(rng.integers(0, n - (1 << 20)))
        rc, _o, _p = run_tool("bwtdecodeblock (index path, 2^20 symbols)", [
            "bwtdecodeblock", "inputtype=pacterm", "ref=" + pac,
            "device=cuda", bwt, str(off), str(1 << 20)])
        if rc != 0 or run_tool.out_bytes != (codes[off:off + (1 << 20)]
                                             + 1).tobytes():
            raise AssertionError("bwtdecodeblock failed on the index path")
        path_counts["index path"] = counts()
        say("index path launches: %s" % path_counts["index path"])
        if min(path_counts["index path"][k] for k in (
                "lf_walk_locate", "lf_walk_decode")) < 1:
            raise AssertionError("the index path did not launch the LF "
                                 "walk's locate and decode visits")
        lap("14, the search's plain version")
        # the search's plain version (the recursion over the plain rank)
        # on the 400 patterns of 200 reads: the same intervals, in order
        with uncounted():
            fm = FMIndex.from_bwt_result(res, device=dev)
            pid, lo, hi, nm = hamdna.hamming_search_batch(fm, pats200, 2)
            t0 = time.monotonic()
            want = hamming_search_plain(fm.rows, fm.dense_ids(np.arange(4)
                                                              + 1), pats200, 2)
            out["hamming_plain_200_s"] = time.monotonic() - t0
        got = [[] for _ in pats200]
        for k, a, b, c in zip(pid.tolist(), lo.tolist(), hi.tolist(),
                              nm.tolist()):
            got[k].append((a, b, c))
        say("allHamDna's search, its plain version (the depth-first "
            "recursion) on the 400 patterns of 200 reads: %.3f s, %d "
            "intervals, %s the breadth-first search's, in order"
            % (out["hamming_plain_200_s"], sum(map(len, want)),
               "equal to" if got == want else "DIFFERENT from"))
        if got != want:
            raise AssertionError("the Hamming search's plain version gives "
                                 "other intervals")
        lap("14, the converters")
        # the converters on the pacterm build
        other = os.path.join(WORK, "other.hwt")
        rc, _, _ = run_tool("bwttohwt recreate=1 (index path)", [
            "bwttohwt", "recreate=1", "outputfilename=" + other, bwt])
        out["bwttohwt_s"] = run_tool.wall
        if rc != 0 or open(other, "rb").read() != open(pac + ".hwt",
                                                       "rb").read():
            raise AssertionError("bwttohwt's .hwt differs from the build's")
        # hwtToRlHwt verify=1 took 72.6 s at 100M on the host of an H100
        # machine (the host decode of the whole tree): it runs on the
        # first 16,777,259 bases
        n16 = 16_777_259
        pac16 = os.path.join(WORK, "chrom16m.pac")
        write_pac(pac16, codes[:n16])
        rc, _, _ = run_tool("bwtb3m inputtype=pacterm bwtonly=1 n=%d (index "
                            "path)" % n16, [
            "bwtb3m", "inputtype=pacterm", "bwtonly=1", "device=cuda",
            pac16])
        rc2, _, _ = run_tool("hwtToRlHwt verify=1 (index path, n=%d)" % n16,
                             ["hwtToRlHwt", "verify=1", pac16 + ".bwt"])
        out["hwttorlhwt_s"] = run_tool.wall
        if rc or rc2 or "verification ok" not in run_tool.log:
            raise AssertionError("hwtToRlHwt verify=1 failed")
        lap("14, the DNR1 converters")
        # DNR1 needs four symbols: a pac build of the same codes
        bwt4 = os.path.join(WORK, "chrom4.bwt")
        rc, _, _ = run_tool("bwtb3m inputtype=pac bwtonly=1 (index path)", [
            "bwtb3m", "inputtype=pac", "bwtonly=1", "device=cuda",
            "outputfilename=" + bwt4, pac])
        bwt4_syms = BwtResult.load(bwt4).load_bwt()
        pos = rng.integers(0, n + 1, 1 << 20)
        want4 = []                     # the BWT's ranks of each symbol
        for c in range(4):
            cs = np.cumsum(bwt4_syms == c, dtype=np.int64)
            want4.append(np.where(pos > 0, cs[np.maximum(pos - 1, 0)], 0))
            del cs
        for tool, block in (("bwttodnarank", 64), ("bwttodnarank256", 256)):
            dst = os.path.join(WORK, "chrom4.%d.dnarank" % block)
            rc, _, _ = run_tool("%s (index path)" % tool, [
                tool, "outputfilename=" + dst, bwt4])
            out[tool + "_s"] = run_tool.wall
            dr = DNARank.read(dst)
            for c in range(4):
                if rc != 0 or dr.block != block \
                        or not np.array_equal(dr.rank(c, pos), want4[c]):
                    raise AssertionError("%s: ranks of symbol %d differ from "
                                         "the BWT's" % (tool, c))
        say("converters (index path, n=%d): bwttohwt %.3f s (== the build's "
            ".hwt), hwtToRlHwt verify=1 %.3f s at n=%d, bwttodnarank %.3f "
            "s, bwttodnarank256 %.3f s (ranks at 2^20 positions == the "
            "BWT's) [%s]" % (n, out["bwttohwt_s"], out["hwttorlhwt_s"], n16,
                             out["bwttodnarank_s"], out["bwttodnarank256_s"],
                             smi))
        lap("14, the visits")
        # the visits at this path's shapes: the hits' locate, the decode
        r_all = torch.from_numpy(seeded_ranks(res.n, len(sa_s),
                                              args.seed + 22)).to(dev)
        out["locate"] = locate_record(fm.rows, r_all, 32, "index path",
                                      PLAIN_SAMPLE[0])
        want = torch.from_numpy(codes[off:off + (1 << 20)] + 1).to(dev)
        out["decode"] = decode_record(
            fm.rows, lambda: fm.decode_plan(off, 1 << 20), off, 1 << 20,
            "index path", want, PLAIN_SAMPLE[1])
        del fm, codes, bwt4_syms
        shutil.rmtree(WORK, ignore_errors=True)
        return out

    def index_kernels(main, cases, extra):
        """The kernels line's rows of the two visits: ``main`` = {"locate":
        rec, "decode": rec} at the main path's shapes, ``cases`` every other
        comparison (their max_abs_err count too)."""
        rows = []
        for name, visit in (("lf_walk_locate", "locate"),
                            ("lf_walk_decode", "decode")):
            rec = main[visit]
            path = ROW_PATH[name] if ROW_PATH[name] in path_counts \
                else "index path"
            rows.append({
                "name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": path_counts[path][name], "shapes_of": path,
                "launches_by_path": {p: c[name]
                                     for p, c in path_counts.items()},
                "max_abs_err": max(errors_in([main, cases])),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "plain_on": rec.get("plain_on"), "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "layout": rec["layout"], "main": rec, **extra})
        return rows

    def say_tools():
        for name, wall, busy in tools:
            say("tool %-36s wall %.3f s, device busy %s [%s]"
                % (name, wall, "not measured" if busy is None
                   else "%.3f s" % busy, smi))

    def finish(kernels=None):
        """The report's tail in every mode: no module of JAX or of the
        JAX package loaded, the time to the report, the nvidia-smi line,
        the kernels line (where given) and the result line."""
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        if loaded:
            raise AssertionError("JAX or the JAX package was imported: %s"
                                 % loaded)
        say("chip_smoke.py: %.3f s from its start to the report [%s]"
            % (time.monotonic() - t_start, smi))
        say(smi)
        if kernels is not None:
            say(json.dumps({"kernels": kernels}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def jobs_seconds(ranks, spawned):
        """Per rank of ``parallel/dryrun.py::run_jobs``: the seconds from
        the spawn to its first job, then each job's."""
        return [[round(r[0]["start"] - spawned, 3)]
                + [round(j["seconds"], 3) for j in r] for r in ranks]

    def sharded_a(rec, keep5):
        """Step 15 (a): a group of one over NCCL, its collectives on card
        tensors, then ``bwtb3m engine=sharded`` through the CLI on step
        5's text and checkbwt of it."""
        from bwtb3m_tpu_torch.parallel import dist as pdist
        from bwtb3m_tpu_torch.parallel import mesh as pm
        from bwtb3m_tpu_torch.parallel.blocksort import exchange
        t0 = time.monotonic()
        with pdist.session("cuda") as mesh:
            t = torch.arange(1 << 20, dtype=torch.int64, device=mesh.device)
            ok = {"backend": (mesh.backend, mesh.world) == ("nccl", 1),
                  "all_reduce": torch.equal(
                      pm.all_reduce(mesh, t.clone(), "sum"), t),
                  "all_gather": torch.equal(pm.all_gather(mesh, t), t[None]),
                  "broadcast": torch.equal(pm.broadcast(mesh, t.clone(), 0),
                                           t),
                  "exchange": torch.equal(exchange(mesh, [t], [(0, 0)])[0],
                                          t)}
        say("sharded (a): a group of one over %s on %s: %s in %.3f s [%s]"
            % (mesh.backend, mesh.device, ok, time.monotonic() - t0, smi))
        if not all(ok.values()):
            raise AssertionError("the NCCL group of one failed a check")
        n5 = os.path.getsize(keep5["text"])
        out = os.path.join(WORK, "sharded.bwt")
        reset_counts()
        rc, _, _ = run_tool("bwtb3m engine=sharded (group of one, NCCL) "
                            "n=%d" % n5, [
                                "bwtb3m", "engine=sharded",
                                "inputtype=bytestream", "device=cuda",
                                "outputfilename=" + out, keep5["text"]])
        if rc != 0 or "sharded, 1 ranks, nccl" not in run_tool.log:
            raise AssertionError("bwtb3m engine=sharded failed or did not "
                                 "run on a group of one over NCCL")
        rec["a_build_s"] = run_tool.wall
        for ext in ("bwt", "hist", "preisa", "sa", "isa"):
            if open(out[:-4] + "." + ext, "rb").read() != \
                    open(keep5[ext], "rb").read():
                raise AssertionError(".%s of engine=sharded differs from "
                                     "step 5's build" % ext)
        rc, stdout, _ = run_tool("checkbwt (engine=sharded build) n=%d" % n5,
                                 ["checkbwt", "inputtype=bytestream",
                                  "device=cuda", keep5["text"], out])
        if rc != 0 or "gok=1" not in stdout:
            raise AssertionError("checkbwt of the sharded build did not "
                                 "print gok=1")
        rec["a_checkbwt_s"] = run_tool.wall
        path_counts["sharded path (group of one)"] = counts()
        if path_counts["sharded path (group of one)"]["lf_walk"] < 1:
            raise AssertionError("checkbwt of the sharded build never "
                                 "launched the LF-walk kernel")
        say("sharded (a): engine=sharded .bwt .hist .preisa .sa .isa == step "
            "5's engine=doubling build at n=%d, checkbwt gok=1; build %.3f "
            "s, checkbwt %.3f s [%s]" % (n5, rec["a_build_s"],
                                         rec["a_checkbwt_s"], smi))
        shutil.rmtree(WORK, ignore_errors=True)

    def sharded_path(keep5, sym8, keep8):
        """Step 15 (module docstring): the sharded paths on the one card.
        ``keep5``: step 5's text and build; ``sym8``: step 8's text (its
        codes), ``keep8`` its engine=doubling build or None.  The ranks of
        (b) and (c) start first, each world in a thread of its own (every
        process takes about 7 s to reach the card, one after the other),
        and this process runs (a) and the references meanwhile.  Returns
        the step's record."""
        import concurrent.futures
        from bwtb3m_tpu_torch.parallel import dist as pdist
        from bwtb3m_tpu_torch.parallel import dryrun
        rec = {}
        t_step = time.monotonic()
        os.makedirs(WORK, exist_ok=True)
        torch.cuda.empty_cache()       # the ranks share the card
        n8 = len(sym8)
        block, lanes = 67108864 // 16, 1 << 16
        rate = 1 << max(5, (max(1, n8 >> 17) - 1).bit_length())
        calls_b = [("sharded_bwt_cases", ([(sym8, 4)],)),
                   ("scaled_cases", (sym8, 4, block, rate, lanes,
                                     [{}, {"BWTB3M_SHARD_OCC": "1"}])),
                   ("level_on_lane_parts", (sym8, 4, block, rate, lanes, 8,
                                            1)),
                   ("imported_reference", ())]
        n4 = 4_194_305
        t4 = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), make_text(
            n4, args.seed + 15)).astype(np.int32)
        calls_c = [("sharded_bwt_cases", ([(t4, 4)],)),
                   ("exchange_seconds", (1 << 24, 3))]
        t_spawn, spawned = time.monotonic(), time.time()

        def world(w, calls):
            """The ranks' results and the seconds from the spawn."""
            out = pdist.run_ranks(dryrun.run_jobs, w, (calls,), "cuda", 600)
            return out, time.monotonic() - t_spawn

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {w: pool.submit(world, w, calls)
                    for w, calls in ((2, calls_b), (3, calls_c))}
            sharded_a(rec, keep5)
            with uncounted():
                sa1, _isa1, bwt1 = suffix_array(sym8, 4, dev)
                del _isa1
                want = merge_scaled.blockwise_bwt_scaled(
                    sym8, 4, BwtOptions(input_path="<mem>",
                                        output_filename=os.devnull,
                                        max_block_symbols=block, verbose=0),
                    VerboseLog(0), sample_rate=rate, lane_bucket=lanes,
                    device=dev)
                sa4, _i4, bwt4 = suffix_array(t4, 4, dev)
            if keep8 is not None:
                _r, sa8 = formats.read_sampled_array(keep8["sa"])
                bwt8 = BwtResult({"files": {"bwt": keep8["bwt"]}}).load_bwt()
                if not (np.array_equal(sa1[::32], sa8)
                        and np.array_equal(bwt1, bwt8)):
                    raise AssertionError("the single-card sort differs from "
                                         "step 8's engine=doubling build")
            ranks, rec["b_ranks_s"] = runs[2].result()
            ranks_c, rec["c_ranks_s"] = runs[3].result()

        # (b) two ranks sharing the card over gloo, on step 8's text
        rec["b_jobs_s"] = jobs_seconds(ranks, spawned)
        (sa, _rank, bwt), = ranks[0][0]["result"]
        if not (np.array_equal(sa, sa1) and np.array_equal(bwt, bwt1)):
            raise AssertionError("sharded_bwt on 2 ranks differs from the "
                                 "single-card sort")
        for r, (_s, scaled, level_job, mods_job) in enumerate(ranks):
            builds, launches = scaled["result"], scaled["launches"]
            level, mods = level_job["result"], mods_job["result"]
            if mods:
                raise AssertionError("rank %d imported %s" % (r, mods))
            rec["b_phases_rank%d" % r] = [w for _g, _m, w in builds]
            for (got, msgs, _w), kind in zip(builds,
                                             ("lanes", "rank range")):
                if kind == "rank range" and not any(
                        "by rank range" in m for m in msgs):
                    raise AssertionError("BWTB3M_SHARD_OCC=1 did not shard "
                                         "the rows")
                for a, b in zip(got, want):
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            "blockwise_bwt_scaled(mesh=) (%s) on rank %d "
                            "differs from the single-card build" % (kind, r))
            path_counts["sharded merges, rank %d" % r] = counts(launches)
            if counts(launches)["gap_chain_mk"] < 1:
                raise AssertionError("rank %d never launched the gap-chain "
                                     "kernel" % r)
            if r == 1:
                compared, _k, same = level[1]
                rec["b_kernel_lanes"] = compared
                if not same or compared < 1:
                    raise AssertionError("bwt_gap_chain_mk differs from its "
                                         "plain version on rank 1's lanes")
        say("sharded (b): 2 ranks sharing the card over gloo, n=%d: "
            "sharded_bwt == single-card sort%s; blockwise_bwt_scaled(mesh=) "
            "mem=67108864 lane-sharded and BWTB3M_SHARD_OCC=1 == single-card "
            "build (bwt, samples, hist); bwt_gap_chain_mk == plain on %d of "
            "rank 1's %d level lanes; %.3f s from the spawn to the results, "
            "by rank the spawn to the first job, then each job %s, the "
            "scaled builds' phases %s; launches %s [%s]"
            % (n8, " == step 8's engine=doubling" if keep8 else "",
               rec["b_kernel_lanes"], level[0], rec["b_ranks_s"],
               json.dumps(rec["b_jobs_s"]),
               json.dumps(rec["b_phases_rank0"]),
               [counts(r[1]["launches"])["gap_chain_mk"] for r in ranks],
               smi))

        # (c) three ranks: the odd-even merge-split rounds
        rec["c_jobs_s"] = jobs_seconds(ranks_c, spawned)
        (sa, _rank, bwt), = ranks_c[0][0]["result"]
        if not (np.array_equal(sa, sa4) and np.array_equal(bwt, bwt4)):
            raise AssertionError("sharded_bwt on 3 ranks differs from the "
                                 "single-card sort")
        if any(r[0]["result"] for r in ranks_c[1:]):
            raise AssertionError("ranks imported %s"
                                 % ranks_c[1][0]["result"])
        ex_s, ex_b = ranks_c[0][1]["result"]
        rec["c_exchange"] = {"bytes": ex_b, "s": ex_s}
        say("sharded (c): 3 ranks sharing the card over gloo, n=%d: "
            "sharded_bwt == single-card sort; %.3f s from the spawn to the "
            "results, by rank %s; an exchange of %d bytes between two ranks "
            "staged through the host %.4f s (%.3f GB/s) [%s]"
            % (n4, rec["c_ranks_s"], json.dumps(rec["c_jobs_s"]), ex_b, ex_s,
               ex_b / ex_s / 1e9, smi))
        shutil.rmtree(KEEP, ignore_errors=True)
        rec["step_s"] = time.monotonic() - t_step
        return rec

    if args.only == "sharded":
        os.makedirs(WORK, exist_ok=True)
        inp5 = os.path.join(WORK, "chr.bin")
        make_text(args.n, args.seed).tofile(inp5)
        rc, _, _ = run_tool("bwtb3m n=%d" % args.n, [
            "bwtb3m", "inputtype=bytestream", "device=cuda", inp5])
        if rc != 0:
            raise AssertionError("bwtb3m failed")
        keep5 = keep_files("chr", {e: inp5 + "." + e for e in
                                   ("bwt", "hist", "preisa", "sa", "isa")})
        keep5.update(keep_files("chr", {"text": inp5}))
        shutil.rmtree(WORK, ignore_errors=True)
        sym8 = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), make_text(
            16_777_259, args.seed + 8)).astype(np.uint8)
        sharded_path(keep5, sym8, None)
        say_tools()
        return finish()

    if args.only == "index":
        idx22 = index_2_22()
        ipath = index_path(args.index_n)
        say_tools()
        return finish(index_kernels(ipath, idx22, {"cases_2^22": idx22}))

    if args.only == "alphabet":
        alpha = alphabet_path(args.alphabet_n, args.alphabet_mem,
                              args.alphabet32_n, args.alphabet32_mem)
        say_tools()
        alphabet_report(alpha)
        return finish(alphabet_kernels(alpha))

    def power_path():
        """Step 8b: ``bwtb3m engine=merge-legacy bwtonly=0 mem=128M`` on
        u^2, u an ACGT text of 10,000,019 symbols past one block of
        8,388,608 (every file from the root, which the scaled engine
        builds, its SA sampled by the select kernel and its ISA by the
        harvest visit), and
        ``checkbwt``; the .bwt, .preisa, .sa and .isa held to the
        single-block route's (``engine/api.py::_power_files_single``: one
        device sort of u), and the root's select launch to its plain
        version on the root's files, rebuilt from that route's BWT and
        .preisa.  Returns the path's record."""
        from bwtb3m_tpu_torch.engine import api as engine_api
        p, mem = 10_000_019, 128 * 1024 ** 2
        t0 = time.monotonic()
        inp = os.path.join(WORK, "power.bin")
        np.tile(make_text(p, args.seed + 15), 2).tofile(inp)
        n, mbs = 2 * p, BwtOptions(input_path=inp, mem=mem).max_block_symbols
        if not mbs < p:
            raise AssertionError("the root of %d symbols fits one block of "
                                 "%d" % (p, mbs))
        say("input: u^2, u = %d ACGT symbols with 1000 mutated repeats "
            "(n=%d, blocks of %d at mem=%d), made in %.2f s (host)"
            % (p, n, mbs, mem, time.monotonic() - t0))
        bwt_file = inp + ".bwt"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, _, phases = run_tool("bwtb3m engine=merge-legacy bwtonly=0 "
                                 "(power path)", [
            "bwtb3m", "inputtype=bytestream", "engine=merge-legacy",
            "bwtonly=0", "mem=%d" % mem, "device=cuda", "verbose=1", inp])
        build_s = run_tool.wall
        if rc != 0 or "scaled build" not in run_tool.log:
            raise AssertionError("the power path's build failed or did not "
                                 "build its root with the scaled engine")
        rc, out, _ = run_tool("checkbwt (power path)", [
            "checkbwt", "inputtype=bytestream", "device=cuda", inp, bwt_file])
        if rc != 0 or "gok=1" not in out:
            raise AssertionError("checkbwt did not print gok=1 on the power "
                                 "path")
        path_counts["power path"] = counts()
        peak = torch.cuda.max_memory_allocated()
        say("power path launches: %s" % path_counts["power path"])
        if min(path_counts["power path"][k] for k in (
                "lf_walk_select", "lf_walk", "gap_chain_mk")) < 1:
            raise AssertionError("the power path did not launch the select, "
                                 "LF-walk and gap-chain kernels")
        with uncounted():
            res = BwtResult.load(bwt_file)
            srate, irate = (res.meta["sasamplingrate"],
                            res.meta["isasamplingrate"])
            prate = res.meta["preisasamplingrate"]
            t0 = time.monotonic()
            w_bwt, w_pos, w_rank, w_sa, w_isa = \
                engine_api._power_files_single(
                    np.fromfile(inp, np.uint8), p, 256, prate, srate, irate,
                    dev, VerboseLog(0))
            single_s = time.monotonic() - t0
            ranks, positions, _rate = res.load_preisa()
            got = {"bwt": (res.load_bwt(), w_bwt),
                   "preisa": (np.r_[positions, ranks], np.r_[w_pos, w_rank]),
                   "sa": (load_sampled_array(res.sa_path)[1], w_sa),
                   "isa": (load_sampled_array(res.isa_path)[1], w_isa)}
            errs = {}
            for ext, (a, b) in got.items():
                if len(a) != len(b):
                    raise AssertionError(".%s has %d values, the single-block "
                                         "route %d" % (ext, len(a), len(b)))
                errs[ext] = int(np.abs(a.astype(np.int64) - b).max())
            say(".bwt, .preisa, .sa and .isa of the power path against the "
                "single-block route (one device sort of the root, %.3f s): "
                "max_abs_err %s (%d / %d sampled values) [%s]"
                % (single_s, json.dumps(errs), len(w_sa), len(w_isa), smi))
            if any(errs.values()):
                raise AssertionError("the power path's files differ from the "
                                     "single-block route's")
            # the root's select launch on the root's files as the build
            # wrote them (the BWT of a primitive root is unique: BWT_t
            # takes each of its symbols twice; its .preisa at the build's
            # rate, ISA_u = ISA_t // 2 below p), its lanes the ranks r // 2
            rprate = min(prate, p)
            rbase = os.path.join(WORK, "power_root")
            files = {"bwt": rbase + ".bwt", "preisa": rbase + ".preisa"}
            write_bwt(files["bwt"], w_bwt[::2].astype(np.uint8), 256)
            below = w_pos < p
            formats.write_preisa(files["preisa"], w_rank[below] // 2,
                                 w_pos[below], rprate)
            formats.write_meta(rbase + ".meta", {
                "format": "bwtb3m_tpu/v1", "n": p, "sigma": 256,
                "files": files})
            r = np.arange(0, n, srate, dtype=np.int64)
            want = np.unique(r // 2)
            sel = select_compare(files["bwt"], want, "power path root")
            sa_u = select_ssa(files["bwt"], want, device=dev)
            if not np.array_equal(
                    sa_u[np.searchsorted(want, r // 2)] + (r % 2) * p, w_sa):
                raise AssertionError("select_ssa on the root disagrees with "
                                     "the root's sort")
            del got, w_bwt, w_pos, w_rank, w_sa, w_isa, sa_u
        rec = {"n": n, "root": p, "max_block_symbols": mbs,
               "build_s": build_s, "checkbwt_s": tools[-1][1],
               "single_block_route_s": single_s, "peak_device_bytes": peak,
               **{"%s_max_abs_err" % ext: e for ext, e in errs.items()},
               "select": sel}
        for name, (wall, dev_s, _span) in sorted(phases.items(),
                                                  key=lambda kv: -kv[1][0]):
            say("power build phase %-18s wall %.3f s, device busy %s [%s]"
                % (name, wall, "%.3f s" % dev_s if dev_s
                   else "not measured", smi))
        say("power path: build %.3f s, checkbwt %.3f s, peak device memory "
            "%.3f GiB [%s]" % (build_s, rec["checkbwt_s"], peak / 2 ** 30,
                               smi))
        return rec

    def power_kernel(rec):
        """The kernels line's row of the select kernel on the power path."""
        main = rec["select"]["sector"]
        return {
            "name": "lf_walk_select_power", "route": "cuda",
            "source": KERNELS["lf_walk_select_power"][0],
            "replaces": KERNELS["lf_walk_select_power"][1],
            "launches": path_counts[ROW_PATH["lf_walk_select_power"]][
                "lf_walk_select"],
            "shapes_of": ROW_PATH["lf_walk_select_power"],
            "entry": "bwt_lf_select on the root of engine=merge-legacy "
                     "bwtonly=0's power text",
            "max_abs_err": max(errors_in(rec)),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "plain_on": main["plain_on"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "layout": "sector", "lanes": main["lanes"],
            "steps": main["steps"], "power_path": {
                k: v for k, v in rec.items() if k != "select"}}

    def fasta_path(n, mem):
        """By hand (``--only fasta``): the genome path's text
        (``make_text(n, seed + 11)``) as a gzipped FASTA of 24 records
        (``write_fasta``), ``fagzToCompact4`` (its ``.meta`` held to the
        records and N runs written) and ``fagzToCompact rc=1`` (its
        length held to 2 (n + 24)) on the host, then ``bwtb3m
        inputtype=compactstream bwtonly=1 mem=<mem>`` from the 2-bit
        compact and ``checkbwt`` of that build in the same process
        (gok=1); the tools' walls, the build's busy time."""
        os.makedirs(WORK, exist_ok=True)
        t0 = time.monotonic()
        codes = make_text(n, args.seed + 11)
        say("genome text: n=%d made in %.3f s (host)"
            % (n, time.monotonic() - t0))
        fa = os.path.join(WORK, "genome.fa.gz")
        t0 = time.monotonic()
        bounds, runs = write_fasta(fa, codes, 24, lower=5)
        del codes
        say("FASTA: 24 records (record 6 lowercase, N runs %s), %d bytes "
            "at gzip level 1, written in %.3f s (host) [%s]"
            % (runs, os.path.getsize(fa), time.monotonic() - t0, smi))
        c4 = os.path.join(WORK, "genome.c4")
        rc, _, _ = run_tool("fagzToCompact4 rc=0 seed=42 n=%d" % n, [
            "fagzToCompact4", "verbose=0", "outputfilename=" + c4, fa],
            profile=False)
        lens = np.diff(bounds)
        if rc != 0 or read_compact4_meta(c4 + ".meta") != [
                (int(lens[k]), [runs[k]] if k in runs else [])
                for k in range(24)]:
            raise AssertionError("fagzToCompact4 failed or its .meta does "
                                 "not hold the records and N runs")
        c3 = os.path.join(WORK, "genome.c3")
        rc, _, _ = run_tool("fagzToCompact rc=1 n=%d" % n, [
            "fagzToCompact", "rc=1", "verbose=0", "outputfilename=" + c3,
            fa], profile=False)
        if rc != 0 or compact.compact_length(c3) != 2 * (n + 24):
            raise AssertionError("fagzToCompact rc=1 failed or wrote a "
                                 "compact of the wrong length")
        os.remove(c3)
        bwt = os.path.join(WORK, "genome.bwt")
        torch.cuda.reset_peak_memory_stats()
        rc, _, phases = run_tool(
            "bwtb3m inputtype=compactstream bwtonly=1 mem=%d n=%d"
            % (mem, n), ["bwtb3m", "inputtype=compactstream", "bwtonly=1",
                         "mem=%d" % mem, "device=cuda",
                         "outputfilename=" + bwt, c4])
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError("bwtb3m from the compact failed")
        rc, out, _ = run_tool("checkbwt inputtype=compactstream n=%d" % n, [
            "checkbwt", "inputtype=compactstream", "device=cuda", c4, bwt])
        if rc != 0 or "gok=1" not in out:
            raise AssertionError("checkbwt of the FASTA build did not print "
                                 "gok=1")
        for name, (wall, dev_s, _span) in sorted(phases.items(),
                                                  key=lambda kv: -kv[1][0]):
            say("FASTA build phase %-18s wall %.3f s, device busy %s [%s]"
                % (name, wall, "%.3f s" % dev_s if dev_s
                   else "not measured", smi))
        say("peak device memory: FASTA build %.3f GiB [%s]"
            % (peak / 2 ** 30, smi))

    if args.only == "power":
        os.makedirs(WORK, exist_ok=True)
        power = power_path()
        shutil.rmtree(WORK, ignore_errors=True)
        say_tools()
        return finish([power_kernel(power)])

    if args.only == "fasta":
        fasta_path(args.genome_n, args.genome_mem)
        shutil.rmtree(WORK, ignore_errors=True)
        say_tools()
        return finish()

    if args.only == "human":
        human = human_path(args.human_n, args.human_mem, args.human_hostmem,
                           args.human_bwtonly, args.human_checks)
        shutil.rmtree(WORK, ignore_errors=True)
        shutil.rmtree(TEXTS, ignore_errors=True)
        say_tools()
        for name, (wall, dev_s, _span) in sorted(human["phases"].items(),
                                                  key=lambda kv: -kv[1][0]):
            say("human-genome build phase %-18s wall %.3f s, device busy %s "
                "[%s]" % (name, wall, "%.3f s" % dev_s if dev_s
                          else "not measured", smi))
        say("peak device memory: human-genome build %.3f GiB, path %.3f GiB "
            "[%s]" % (human["peak_build"] / 2 ** 30,
                      human.get("peak", 0) / 2 ** 30, smi))
        return finish()
    LAYOUTS_OF = {4: ("sector", "bitplane"), 7: ("bitplane",),
                  200: ("bytes",)}

    lap("3")
    # ---- 3. LF-walk kernel against its plain version at 2^22 -----------
    def lanes_for(isa, n, nlanes):
        rate = n // nlanes
        pos = np.arange(0, n, rate, dtype=np.int64)
        seg = np.diff(np.r_[pos, n])
        start = (pos + seg) % n          # lane 0 wraps through n-1, ...
        return [torch.from_numpy(a).to(dev) for a in (isa[start], start, seg)]

    def doctor_base(bwt, sigma):
        """Counts before position 0 that put every symbol's occ count
        across 2^32 halfway through the rows (``ops/wideocc.py::doctored``)."""
        cnt = np.bincount(bwt, minlength=sigma)
        return torch.from_numpy(((1 << 32) - cnt // 2).astype(np.int64)), cnt

    W22 = {"lf_walk_w": {}, "gap_chain_mk_w": {}}

    def wide_lf_2_22(sigma, layout, bwt, sa, isa, t_dev, r0, p0, seg, focc,
                     narrow):
        """``bwt_lf_walk_w`` (final rank, verify, harvest) against its
        plain version on rows doctored so that every count straddles 2^32;
        the 64-bit form on the undoctored rows and on the doctored ones
        gives the narrow form's final ranks."""
        base, cnt = doctor_base(bwt, sigma)
        bwt_dev = torch.from_numpy(bwt.astype(np.uint8)).to(dev)
        w = pw.doctored(bwt_dev, sigma, layout, base)
        if int((w.thr != pw.THR_PAD).sum()) != int((cnt > 0).sum()):
            raise AssertionError("the doctored rows do not wrap once per "
                                 "symbol")
        undoctored = build_focc_device(bwt_dev, sigma, layout, wide=True)
        del bwt_dev
        checks = {}
        k, k_ms = timed(lambda: lw.lf_walk(w, r0, 256), reps=5)
        p, p_ms = timed(lambda: lw.lf_walk_plain(w, r0, 256))
        same = lw.lf_walk(focc, r0, 256)
        if not (torch.equal(k, same)
                and torch.equal(lw.lf_walk(undoctored, r0, 256), same)):
            raise AssertionError("the 64-bit form's final ranks differ from "
                                 "the narrow form's")
        checks["lf_walk"] = (max_err(k, p), k_ms, p_ms)
        k, k_ms = timed(lambda: lw.verify_walk(w, t_dev, r0, p0, seg),
                        reps=5)
        p, p_ms = timed(lambda: lw.verify_walk_plain(w, t_dev, r0, p0, seg))
        if int(k.sum()) != 1:
            raise AssertionError("the 64-bit verify walk found %d "
                                 "mismatches, want 1" % int(k.sum()))
        checks["verify_walk"] = (max_err(k, p), k_ms, p_ms)
        (ks, ki), k_ms = timed(lambda: lw.harvest_walk(
            w, r0, p0, seg, 32, 262144), reps=5)
        (ps, pi), p_ms = timed(lambda: lw.harvest_walk_plain(
            w, r0, p0, seg, 32, 262144))
        if not (np.array_equal(ks.cpu().numpy(), sa[::32])
                and np.array_equal(ki.cpu().numpy(), isa[::262144])):
            raise AssertionError("the 64-bit harvest walk disagrees with "
                                 "the sort")
        checks["harvest_walk"] = (max(max_err(ks, ps), max_err(ki, pi)),
                                  k_ms, p_ms)
        # bytes moved once and steps taken, as lf_compare counts them
        lanes, total = len(r0), int(seg.sum())
        tables = nbytes(w.rows, w.thr, w.C)
        work = {"lf_walk": (tables + 16 * lanes + 4 * lanes, 256 * lanes),
                "verify_walk": (tables + nbytes(t_dev) + 24 * lanes
                                + 8 * lanes, total),
                "harvest_walk": (tables + 28 * lanes + nbytes(ks, ki), total)}
        ops = LF_STEP_OPS[layout] + WIDE_STEP_OPS
        for name, (err, k_ms, p_ms) in checks.items():
            b_ms, b_by = bound(work[name][0], work[name][1] * ops)
            checks[name] = (err, k_ms, p_ms, b_ms, b_by)
            say("kernel %-12s 64-bit form, sigma=%-3d %-8s rows n=2^22 "
                "doctored across 2^32, lanes=%d: max_abs_err %d, kernel "
                "%.3f ms (narrow form %.3f ms), plain %.3f ms, bound %.3f ms "
                "(%s)" % (name, sigma, layout, lanes, err, k_ms,
                          narrow[name][1], p_ms, b_ms, b_by))
            if err:
                raise AssertionError("%s's 64-bit form disagrees with its "
                                     "plain version" % name)
        W22["lf_walk_w"]["sigma=%d %s" % (sigma, layout)] = {
            name: {"max_abs_err": e, "ms": k_ms, "narrow_ms": narrow[name][1],
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            for name, (e, k_ms, p_ms, b_ms, b_by) in checks.items()}

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
            wide_lf_2_22(sigma, layout, bwt, sa, isa, t_dev, r0, p0, seg,
                         focc, checks)

    lap("3c")
    # ---- 3c. the locate and decode visits at 2^22 (phase a) -------------
    idx22 = index_2_22()

    lap("3b")
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

    lap("4")
    # ---- 4. gap-chain kernel against its plain version at 2^22 ---------
    def one_merge(text_dev, text_host, sigma, s, m, e, r_start, hist, packed,
                  rate, layouts, lane_bucket=1 << 16, wide=False):
        """A pair merge as a level of one, and its rank rows per layout;
        with ``wide`` the runner's wide mode (the 64-bit form) and wide
        rows."""
        bits = bits_for(sigma)
        level = gb.BatchedGapRunner(
            text_dev, text_host, sigma, [(s, m, e, r_start, hist)], [packed],
            bits, lane_bucket=lane_bucket, sample_rate=rate,
            layout=layouts[0], wide=wide)
        foccs = {layouts[0]: level.focc}
        for lay in layouts[1:]:
            foccs[lay] = (build_focc_from_packed(packed, e - m, sigma, bits,
                                                 lay, wide=True) if wide
                          else build_focc_concat([packed], [e - m], sigma,
                                                 bits, lay)[0])
        return level, foccs

    def chain_at_base(level, focc, lanes, rbase, label):
        """The 64-bit form with the merge's ranks moved up by ``rbase``
        (past 2^32): the rank rows', histogram's pointers handed to the
        kernel lowered by the same rows and cells, c_first, isa_m and the
        seeds raised by ``rbase``, so that every rank the kernel computes,
        writes and indexes with passes 2^32.  Held to the plain version
        at rank base 0: final ranks and samples less ``rbase``, the
        histogram cell for cell.  A direct launch: not counted."""
        kid, starts, seeds, lens = lanes
        kd, st, sd, ln = level._lanes(kid, starts, seeds, lens)
        rate = level.sample_rate
        gap, samp, clear = level_buffers(level, focc)
        clear()
        fp = gb.gap_chain_mk_plain(*mk_args(level, focc, kd, st), sd, ln,
                                   gap, samp, rate)
        want_gap, want_samp = gap.clone(), samp.clone()
        clear()
        table = level.table.clone()
        table[:, gb.M_K0] += rbase
        c_first = level.c_first + rbase
        thr, _c64 = pw.kernel_tables(focc)
        sd_hi = sd + rbase
        r_out = torch.empty_like(sd)
        shift = rbase >> focc.SHIFT
        lib = _build.load("gap_chain")
        rc = lib.bwt_gap_chain_mk_w(
            ctypes.c_void_p(focc.rows.data_ptr()
                            - shift * focc.rows.shape[1]),
            focc.rows.shape[1], ctypes.c_void_p(thr.data_ptr()), focc.sigma,
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                level.text_dev, level.gt_dev, c_first, table, kd, st)),
            ctypes.c_void_p(sd_hi.data_ptr()),
            ctypes.c_void_p(ln.data_ptr()), ctypes.c_void_p(r_out.data_ptr()),
            ctypes.c_void_p(gap.data_ptr() - 8 * rbase),
            ctypes.c_void_p(samp.data_ptr()), rate, len(sd),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError("bwt_gap_chain_mk_w failed: %d" % rc)
        seen = samp != -1
        err = max(max_err(r_out - rbase, fp), max_err(gap, want_gap),
                  max_err(torch.where(seen, samp - rbase, -1), want_samp))
        say("kernel gap_chain_mk 64-bit form, %s, rank base 2^32 + 2^20 "
            "(ranks %d..%d): max_abs_err %d against the plain version at "
            "base 0" % (label, rbase, rbase + focc.n, err))
        if err or int(r_out.min()) < 1 << 32:
            raise AssertionError("the 64-bit chain disagrees at a rank base "
                                 "past 2^32")
        return err

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
        # the 64-bit form on the same merge: the wide runner's rows, then
        # rows doctored so that every count crosses 2^32 (c_first lowered
        # by the same base), its own anchors and chains on them, and a
        # rank base past 2^32
        packed = rows_from_host_bwt(rbwt, sigma, dev)
        wlevel, wfoccs = one_merge(
            torch.from_numpy(text).to(dev), text, sigma, 0, m_g, n_g,
            int(R[m_g]), np.bincount(text[m_g:], minlength=sigma), packed,
            64, layouts, wide=True)
        base, _cnt = doctor_base(rbwt, sigma)
        c_first0 = wlevel.c_first
        rbwt_dev = torch.from_numpy(rbwt).to(dev)
        lanes_w = (np.zeros(len(starts), np.int64), starts, R[starts + 1],
                   lens)
        for lay, wf in wfoccs.items():
            label = ("sigma=%-3d right 2^22 ranks, left 2^22, 65536 lanes:"
                     % sigma)
            res = level_compare(wlevel, {lay: wf}, lanes_w, 5, True, label)
            doc = pw.doctored(rbwt_dev, sigma, lay, base)
            wlevel.focc, wlevel.c_first = doc, c_first0 - base.to(dev)
            wlevel.compute()
            view = wlevel.view(0)
            if not (np.array_equal(view.harvest_samples()[1], R[0:m_g:64])
                    and np.array_equal(
                        view.gap.cpu().numpy(),
                        np.bincount(R[:m_g], minlength=n_g - m_g + 1))):
                raise AssertionError("the 64-bit chain on doctored rows "
                                     "disagrees with the sort")
            res_d = level_compare(wlevel, {lay: doc}, lanes_w, 5, True,
                                  label + " doctored across 2^32,")
            wlevel.focc, wlevel.c_first = wf, c_first0
            err = chain_at_base(wlevel, wf, lanes_w, (1 << 32) + (1 << 20),
                                "sigma=%d %s rows" % (sigma, lay))
            W22["gap_chain_mk_w"]["sigma=%d %s" % (sigma, lay)] = {
                "rows": res[lay], "doctored": res_d[lay],
                "rank_base_past_2^32_max_abs_err": err}
            del doc
        del level, foccs, wlevel, wfoccs, sa, isa, R, rbwt_dev

    lap("4b")
    # ---- 4b. the Kasai walk against its plain version at 2^22 ----------
    def kasai_bound(words, npos, steps):
        """(ms, which) of a walk over ``npos`` positions: the text words
        and Phi read once and PLCP written once, or its steps."""
        return bound(nbytes(words) + 8 * npos, steps * KASAI_STEP_OPS)

    def kasai_run(words, phi, p0, p, pend, n, a, bits, steps=None,
                  plain=False):
        """(plcp, p, l, taken) of the walk over the slab of ``phi`` from
        fresh buffers, by the kernel or its plain version."""
        plcp = torch.zeros(phi.shape[0], dtype=torch.int32, device=dev)
        taken = torch.zeros(len(p), dtype=torch.int32, device=dev)
        fn = kas.kasai_plain if plain else kas.kasai_walk
        out = fn(words, phi, p0, plcp, p, torch.zeros_like(p), pend, n, a,
                 bits, steps=steps, taken=taken)
        return out + (taken,)

    def kasai_err(x, y):
        return max(max_err(u, v) for u, v in zip(x, y))

    KASAI_CAP = 1024     # the plain version's steps on 128-lane cases
    kasai_22 = {}
    n_k = 1 << 22
    for label, sigma, text in (
            ("sigma=4", 4, np.random.default_rng(args.seed + 60).integers(
                0, 4, n_k).astype(np.uint8)),
            ("sigma=200", 200, np.random.default_rng(args.seed + 61)
             .integers(0, 200, n_k).astype(np.uint8)),
            ("10,000-symbol repeats", 4, repeats_text(n_k, args.seed + 62))):
        sa, _isa, _bwt = suffix_array(text, sigma, dev)
        want = lp.kasai_plcp(text, sa)
        words, phi_all, p0, bits = lp.device_walk_arrays(
            text, sigma, torch.from_numpy(sa).to(dev))
        for lanes in (1 << 17, 128):
            for slabs in ([(0, n_k)], [(0, n_k // 2), (n_k // 2, n_k)]):
                rec = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                       "bound_ms": 0.0, "steps": 0}
                plcp_all = []
                for a, b in slabs:
                    phi = phi_all[a:b]
                    p, pend = lp._lane_bounds(a, b, lanes, dev)
                    full, k_ms = timed(lambda: kasai_run(
                        words, phi, p0, p, pend, n_k, a, bits), reps=3)
                    cap = None if lanes > KASAI_CAP else KASAI_CAP
                    kern = full if cap is None else kasai_run(
                        words, phi, p0, p, pend, n_k, a, bits, cap)
                    plain, p_ms = timed(lambda: kasai_run(
                        words, phi, p0, p, pend, n_k, a, bits, cap,
                        plain=True), warm=False)
                    err = kasai_err(kern, plain)
                    steps = int(full[3].sum())
                    b_ms, b_by = kasai_bound(words, b - a, steps)
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    rec["ms"] += k_ms
                    rec["plain_ms"] += p_ms
                    rec["bound_ms"] += b_ms
                    rec["bound_by"] = b_by
                    rec["steps"] += steps
                    plcp_all.append(full[0])
                    if err or not np.array_equal(full[0].cpu().numpy(),
                                                 want[a:b]):
                        raise AssertionError(
                            "the Kasai kernel disagrees with its plain "
                            "version or the host oracle (%s, %d lanes, "
                            "slab [%d, %d))" % (label, lanes, a, b))
                if lanes <= KASAI_CAP:
                    rec["plain_on"] = {"lanes": lanes,
                                       "steps_at_most": KASAI_CAP}
                plcp = torch.cat(plcp_all)
                del full, kern, plain, plcp_all
                nbits, by = lp.encode_plcp_bits_device(plcp)
                host = lp.encode_plcp_bits(want)
                if nbits != len(host) or not np.array_equal(
                        np.unpackbits(by, bitorder="little")[:nbits], host):
                    raise AssertionError("the device encoder disagrees with "
                                         "the host's (%s)" % label)
                key = "%s, %d lanes, %d slab(s)" % (label, lanes, len(slabs))
                kasai_22[key] = rec
                say("kernel kasai %s, n=2^22 (%d steps): max_abs_err %d, "
                    "kernel %.3f ms (%.2f G steps/s), plain %.3f ms%s, bound "
                    "%.3f ms (%s); device encode == host encode [%s]"
                    % (key, rec["steps"], rec["max_abs_err"], rec["ms"],
                       rec["steps"] / rec["ms"] / 1e6, rec["plain_ms"],
                       " at %d steps" % KASAI_CAP if lanes <= KASAI_CAP
                       else "", rec["bound_ms"], rec["bound_by"], smi))
        del words, phi_all, sa, want, plcp

    lap("5")
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
    keep5 = keep_files("chr", {"text": inp, "bwt": bwt_path,
                               "hist": inp + ".hist",
                               "preisa": inp + ".preisa", "sa": ref_sa,
                               "isa": ref_isa})
    say("single-block path launches: %s" % path_counts["single-block path"])
    if path_counts["single-block path"]["lf_walk"] < 1:
        raise AssertionError("the single-block path never launched the "
                             "LF-walk kernel")

    lap("5b")
    # ---- 5b. the single-block path's PLCP -------------------------------
    def moved_bit_copy(lcpbit, bad):
        """A copy of a .lcpbit with the first set bit after the first that
        has a clear bit after it moved there: still n ones, one PLCP
        value one higher."""
        blob = bytearray(open(lcpbit, "rb").read())
        bits = np.unpackbits(np.frombuffer(bytes(blob[20:20 + (1 << 20)]),
                                           np.uint8), bitorder="little")
        ones = np.flatnonzero(bits[:-1] & ~bits[1:])
        j = int(ones[ones > 0][0])
        blob[20 + j // 8] &= 0xFF ^ (1 << (j % 8))
        blob[20 + (j + 1) // 8] |= 1 << ((j + 1) % 8)
        with open(bad, "wb") as f:
            f.write(bytes(blob))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    lcpbit_s = inp + ".lcpbit"
    rc, _, _ = run_tool("lcpbit (single-block path)",
                        ["lcpbit", "device=cuda", bwt_path])
    if rc != 0 or "plcp: device route" not in run_tool.log:
        raise AssertionError("lcpbit failed or did not take the device "
                             "route")
    path_counts["single-block LCP path"] = counts()
    peak_lcp_single = torch.cuda.max_memory_allocated()
    say("single-block LCP path launches: %s"
        % path_counts["single-block LCP path"])
    if path_counts["single-block LCP path"]["kasai"] < 1:
        raise AssertionError("lcpbit never launched the Kasai kernel")

    lap("6")
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

    lap("7")
    # ---- 7. LF-walk kernel at the single-block path's shapes -------------
    lf_single = lf_compare(bwt_path, text, "single-block path",
                           sample=PLAIN_SAMPLE)
    del text
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    lap("8")
    # ---- 8. the FASTA path: three engines at 2^24 + 43 -------------------
    n8 = 16_777_259
    codes8 = make_text(n8, args.seed + 8)
    fa8 = os.path.join(WORK, "mid.fa.gz")
    t0 = time.monotonic()
    bounds8, runs8 = write_fasta(fa8, codes8, 16, lower=5)
    say("FASTA: n=%d in 16 records (record 6 lowercase, N runs %s), "
        "gzip level 1, written in %.3f s (host)"
        % (n8, runs8, time.monotonic() - t0))
    c4 = os.path.join(WORK, "mid.c4")
    rc, _, _ = run_tool("fagzToCompact4 rc=0 seed=42 n=%d" % n8, [
        "fagzToCompact4", "rc=0", "seed=42", "verbose=0",
        "outputfilename=" + c4, fa8], profile=False)
    lens8 = np.diff(bounds8)
    meta4 = read_compact4_meta(c4 + ".meta")
    if rc != 0 or meta4 != [(int(lens8[k]), [runs8[k]] if k in runs8
                             else []) for k in range(16)]:
        raise AssertionError("fagzToCompact4's .meta does not hold the "
                             "records and N runs written")
    t0 = time.monotonic()
    sym8, bits8 = compact.read_compact(c4)
    keep8 = np.ones(n8, bool)
    for k, (a, b) in runs8.items():
        keep8[bounds8[k] + a:bounds8[k] + b] = False
    if bits8 != 2 or not np.array_equal(
            sym8[keep8], np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                         codes8[keep8])):
        raise AssertionError("the compact does not hold the text's codes "
                             "outside the N runs")
    del sym8, keep8, codes8
    say("fagzToCompact4: .meta holds the 16 records and both N runs, the "
        "compact the text's codes elsewhere (checked in %.3f s)"
        % (time.monotonic() - t0))
    outs = {}
    reset_counts()
    for eng, extra in (("merge", ["mem=67108864"]), ("doubling", []),
                       ("merge-legacy", ["mem=67108864"])):
        outs[eng] = os.path.join(WORK, "mid_%s.bwt" % eng)
        rc, _, _ = run_tool("bwtb3m inputtype=compactstream engine=%s n=%d"
                            % (eng, n8), [
            "bwtb3m", "inputtype=compactstream", "bwtonly=1", "device=cuda",
            "engine=" + eng, "outputfilename=" + outs[eng], *extra, c4],
            profile=False)
        if rc != 0:
            raise AssertionError("bwtb3m engine=%s failed" % eng)
    for ext in ("bwt", "hist", "preisa"):
        a, b, c = (open(outs[e][:-4] + "." + ext, "rb").read()
                   for e in ("merge", "doubling", "merge-legacy"))
        if not a == b == c:
            raise AssertionError(".%s of engine=merge, doubling and "
                                 "merge-legacy differ" % ext)
    say("engine=merge (mem=67108864: 5 blocks, 3 levels) == engine=doubling "
        "== engine=merge-legacy at n=%d from fagzToCompact4's compact: "
        ".bwt .hist .preisa byte-identical" % n8)
    rc, out, _ = run_tool("checkbwt inputtype=compactstream n=%d" % n8, [
        "checkbwt", "inputtype=compactstream", "device=cuda", c4,
        outs["merge-legacy"]], profile=False)
    if rc != 0 or "gok=1" not in out:
        raise AssertionError("checkbwt of the compact did not print gok=1")
    base8 = outs["doubling"][:-4]
    rc, _, _ = run_tool("bwtcomputessa (FASTA path) n=%d" % n8, [
        "bwtcomputessa", "sasamplingrate=32", "isasamplingrate=262144",
        "device=cuda", outs["doubling"]], profile=False)
    path_counts["FASTA path"] = counts()
    keep8 = keep_files("mid", {"compact": c4, "bwt": outs["doubling"],
                               "sa": base8 + ".sa"})
    say("FASTA path launches: %s" % path_counts["FASTA path"])
    if rc != 0 or path_counts["FASTA path"]["lf_walk"] < 1 \
            or path_counts["FASTA path"]["gap_chain_mk"] < 1:
        raise AssertionError("the FASTA path failed or never launched the "
                             "LF-walk and gap-chain kernels")
    rc, _, _ = run_tool("fa4suffixarraytocompact n=%d" % n8, [
        "fa4suffixarraytocompact", "verbose=0",
        "outputfilename=" + base8 + ".fa4c", base8 + ".sa", c4 + ".meta"],
        profile=False)
    coords, _bits = compact.read_compact(base8 + ".fa4c")
    obits = max(1, int(lens8.max() - 1).bit_length())
    _rate, sa8 = formats.read_sampled_array(base8 + ".sa")
    if rc != 0 or not np.array_equal(
            bounds8[coords >> obits] + (coords & ((1 << obits) - 1)), sa8):
        raise AssertionError("fa4suffixarraytocompact's coordinates do not "
                             "decode to the .sa's positions")
    say("fa4suffixarraytocompact: %d (record, offset) coordinates of %d "
        "offset bits decode to the .sa's positions" % (len(coords), obits))
    del coords, sa8
    # hwtToLCP on that build: .ulcp, .lcp, .rmm and checklcp=1 (the host
    # oracle over the same SA, and the .lcp read back)
    reset_counts()
    rc, _, _ = run_tool("hwtToLCP checklcp=1 n=%d" % n8, [
        "hwtToLCP", "checklcp=1", "device=cuda", outs["doubling"]])
    if rc != 0 or "checklcp ok" not in run_tool.log or not all(
            os.path.getsize(base8 + ext) for ext in (".ulcp", ".lcp", ".rmm")):
        raise AssertionError("hwtToLCP checklcp=1 failed")
    path_counts["hwtToLCP path"] = counts()
    if path_counts["hwtToLCP path"]["kasai"] < 1:
        raise AssertionError("hwtToLCP never launched the Kasai kernel")
    # checkLCPBit's host oracle here, not at the single-block path's
    # 100,000,003 (12-23 s a call there): lcpok=1 on this build's
    # .lcpbit, lcpok=0 on a copy with one bit moved
    lcpbit8 = base8 + ".lcpbit"
    rc, _, _ = run_tool("lcpbit n=%d" % n8, ["lcpbit", "device=cuda",
                                             outs["doubling"]])
    rc2, out, _ = run_tool("checkLCPBit n=%d" % n8, [
        "checkLCPBit", "device=cuda", lcpbit8, outs["doubling"]])
    if rc != 0 or rc2 != 0 or out.strip() != "lcpok=1":
        raise AssertionError("checkLCPBit did not print lcpok=1")
    moved_bit_copy(lcpbit8, os.path.join(WORK, "bad.lcpbit"))
    rc, out, _ = run_tool("checkLCPBit (one bit moved) n=%d" % n8,
                          ["checkLCPBit", "device=cuda",
                           os.path.join(WORK, "bad.lcpbit"), outs["doubling"]])
    if rc != 1 or out.strip() != "lcpok=0":
        raise AssertionError("checkLCPBit did not print lcpok=0 on the copy "
                             "with one bit moved")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    lap("8b")
    # ---- 8b. the power path: merge-legacy bwtonly=0 on u^2 -------------
    power = power_path()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    lap("9")
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
    if min(path_counts["merge path"][k] for k in ("lf_walk", "gap_chain")) < 1:
        raise AssertionError("the merge path did not launch every kernel")
    prate = ssa_agrees_with_preisa(bwtm, "merge build")
    # the LF walk at the merge path's shapes (the rank rows come from the
    # memo that checkbwt and bwtcomputessa filled)
    lf_merge = lf_compare(bwtm, text, "merge path", sample=PLAIN_SAMPLE)

    lap("10")
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
                       "%s, %d lanes):" % (root, len(starts)),
                       sample=PLAIN_SAMPLE)
    # the same merge through the runner's wide mode and the kernel's
    # 64-bit form (what BWTB3M_FORCE_WIDE and a merge past 2^32 run):
    # its own anchors give the same lanes, then the kernel against its
    # plain version on them, beside the narrow form's times above
    wlevel, wfoccs = one_merge(ctx.text_dev, ctx.text, 4, s_r, m_r, e_r,
                               right.r_start, right.hist, right.packed,
                               prate, ("sector",), wide=True)
    wlevel.anchor_all()
    if not all(np.array_equal(a, b)
               for a, b in zip(level_lanes(wlevel), lanes)):
        raise AssertionError("the wide runner's anchors differ from the "
                             "narrow runner's")
    gcw = level_compare(wlevel, wfoccs, lanes, 3, False,
                        "%s, %d lanes):" % (root, len(starts)),
                        sample=PLAIN_SAMPLE)
    for lay, o in gcw.items():
        say("gap_chain_mk %s, %d lanes), %s rows: 64-bit form %.3f ms "
            "(recording %.3f), narrow form %.3f ms (recording %.3f): %.3f x "
            "[%s]" % (root, len(starts), lay, o["ms"],
                      o["forms"]["recording"], gc[lay]["ms"],
                      gc[lay]["forms"]["recording"],
                      o["ms"] / gc[lay]["ms"], smi))
    del wlevel, wfoccs

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

    lap("10b")
    # ---- 10b. the forced-wide merge path -------------------------------
    # the 400M build once more with every merge wide; its files, checkbwt
    # and bwtcomputessa (wide rows, the LF walk's 64-bit form) against the
    # narrow run's
    bwtw = os.path.join(WORK, "big_wide.bwt")
    os.environ["BWTB3M_FORCE_WIDE"] = "1"
    try:
        reset_counts()
        rc, _, wide_phases = run_tool("bwtb3m BWTB3M_FORCE_WIDE=1 (merge "
                                      "path)", [
            "bwtb3m", "inputtype=bytestream", "bwtonly=1", "device=cuda",
            "mem=%d" % args.merge_mem, "outputfilename=" + bwtw, inpm])
        if rc != 0 or "wide pair merge" not in run_tool.log:
            raise AssertionError("the forced-wide build failed or did not "
                                 "take the wide merges")
        for ext in ("bwt", "hist", "preisa"):
            if open(inpm + "." + ext, "rb").read() != \
                    open(bwtw[:-4] + "." + ext, "rb").read():
                raise AssertionError(".%s of the forced-wide build differs "
                                     "from the narrow build" % ext)
        say("BWTB3M_FORCE_WIDE=1 build == narrow build at n=%d: .bwt .hist "
            ".preisa byte-identical" % nm)
        rc, out, _ = run_tool("checkbwt BWTB3M_FORCE_WIDE=1 (merge path)", [
            "checkbwt", "inputtype=bytestream", "device=cuda", inpm, bwtw])
        if rc != 0 or "gok=1" not in out or "wide rows" not in run_tool.log:
            raise AssertionError("checkbwt on wide rows did not print gok=1")
        rc, _, _ = run_tool("bwtcomputessa BWTB3M_FORCE_WIDE=1 (merge path)",
                            ["bwtcomputessa", "sasamplingrate=32",
                             "isasamplingrate=262144", "device=cuda", bwtw])
        for ext in ("sa", "isa"):
            if rc != 0 or open(inpm + "." + ext, "rb").read() != \
                    open(bwtw[:-4] + "." + ext, "rb").read():
                raise AssertionError("bwtcomputessa's .%s on wide rows "
                                     "differs from the narrow run's" % ext)
        say("checkbwt gok=1 and bwtcomputessa .sa/.isa byte-identical to "
            "the narrow run's, on wide rows")
        path_counts["forced-wide merge path"] = counts()
        say("forced-wide merge path launches: %s"
            % path_counts["forced-wide merge path"])
        c = path_counts["forced-wide merge path"]
        if min(c["lf_walk_w"], c["gap_chain_mk_w"]) < 1 \
                or c["lf_walk"] + c["gap_chain"] + c["lf_walk_select"]:
            raise AssertionError("the forced-wide path did not run on the "
                                 "64-bit forms alone")
        lf_wide = lf_compare(bwtw, np.fromfile(inpm, np.uint8),
                             "forced-wide merge path", ("sector",),
                             ("verify_walk", "harvest_walk"), wide=True,
                             sample=PLAIN_SAMPLE)
        for lay, o in lf_wide.items():
            say("kernel lf_walk verify + harvest at n=%d, %s rows: 64-bit "
                "form %.3f ms, narrow form %.3f ms: %.3f x [%s]"
                % (nm, lay, o["ms"], lf_merge[lay]["ms"],
                   o["ms"] / lf_merge[lay]["ms"], smi))
        # the FM index's locate on the wide rows (the 64-bit form) against
        # the narrow rows' (below), on the .sa of bwtcomputessa
        register_samples(bwtw)
        _r, sa_w = load_sampled_array(bwtw[:-4] + ".sa")
        want_w = seeded_ranks(nm, len(sa_w), args.seed + 23)
        with uncounted():
            fm_w = FMIndex.from_bwt_result(BwtResult.load(bwtw), device=dev)
            if not is_wide(fm_w.rows):
                raise AssertionError("the FM index did not take wide rows")
            loc_wide = fm_w.locate_batch(want_w)
            fw_locate = locate_record(fm_w.rows, torch.from_numpy(want_w)
                                      .to(dev), 32,
                                      "forced-wide merge path",
                                      PLAIN_SAMPLE[0])
        del fm_w
    finally:
        del os.environ["BWTB3M_FORCE_WIDE"]
    with uncounted():
        fm_n = FMIndex.from_bwt_result(BwtResult.load(bwtw), device=dev)
        loc_narrow = fm_n.locate_batch(want_w)
        fw_locate["narrow"] = locate_record(
            fm_n.rows, torch.from_numpy(want_w).to(dev), 32,
            "merge path, narrow rows", PLAIN_SAMPLE[0])
    del fm_n
    half = len(want_w) // 2
    if not (np.array_equal(loc_wide, loc_narrow) and np.array_equal(
            loc_wide[half:], sa_w[want_w[half:] // 32])):
        raise AssertionError("locate_batch on wide rows disagrees with the "
                             "narrow rows or the .sa at n=%d" % nm)
    say("locate_batch of 2^20 ranks at n=%d: wide rows (the 64-bit form) == "
        "narrow rows == the .sa at the sampled ranks; kernel %.3f ms against "
        "%.3f ms narrow [%s]" % (nm, fw_locate["ms"],
                                 fw_locate["narrow"]["ms"], smi))

    lap("11")
    # ---- 11. the genome path ---------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ng = args.genome_n
    wide = ng >= 1 << 32      # the tools' walks take the 64-bit form
    inpg = os.path.join(WORK, "genome.bin")
    text, waited = take_text("genome.bin", inpg)
    say("input: n=%d ACGT with 1000 mutated repeats, made by a process of "
        "its own during the earlier steps (%.2f s waited for it)"
        % (ng, waited))
    bwtg = inpg + ".bwt"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, _, genome_phases = run_tool("bwtb3m (genome path)", [
        "bwtb3m", "inputtype=bytestream", "bwtonly=0", "sasamplingrate=32",
        "isasamplingrate=262144", "device=cuda", "mem=%d" % args.genome_mem,
        "hostmem=%d" % args.genome_hostmem, inpg])
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
    chains = gb.LAUNCHES["chain"] + gb.LAUNCHES["chain64"]
    if len(levels) != want_levels or chains != depth:
        raise AssertionError("%d blocks: expected %d batched levels of %d, "
                             "the build ran %d (%d launches of the chain "
                             "form)" % (nblocks, want_levels, depth,
                                        len(levels), chains))
    if "hand-off" not in build_log:
        raise AssertionError("the build's SA/ISA walk did not take its "
                             "rank rows from the hand-off")
    rc, out, _ = run_tool("checkbwt (genome path, in the build's process)",
                          ["checkbwt", "inputtype=bytestream", "device=cuda",
                           inpg, bwtg])
    if rc != 0 or "gok=1" not in out or "decode" in run_tool.log:
        raise AssertionError("checkbwt through the hand-off did not print "
                             "gok=1, or decoded the file")
    # checkbwt in a fresh process from .bwt: beside the .lcpbit read-back
    # in step 11c (both host work), here where the path has no PLCP
    if ng >= 1 << 31:
        finish_checkbwt(start_checkbwt(inpg, bwtg), "genome path")
    isa_build = open(inpg + ".isa", "rb").read()
    rc, _, _ = run_tool("hwtPreIsaToIsa (genome path)", [
        "hwtPreIsaToIsa", "isasamplingrate=262144", "device=cuda", bwtg])
    if rc != 0 or open(inpg + ".isa", "rb").read() != isa_build:
        raise AssertionError("hwtPreIsaToIsa's .isa differs from the build's")
    # select_ssa stops at 2^32 symbols (ROADMAP.md item 8)
    want_ranks = None if wide else select_agrees_with_sa(bwtg, args.seed + 12)
    # the FM index on the build: locate_batch and bwtdecodeblock
    gidx = None if wide else genome_index(bwtg, inpg, text, "genome path")
    peak_genome = torch.cuda.max_memory_allocated()
    path_counts["genome path"] = counts()
    say("genome path launches: %s" % path_counts["genome path"])
    need = ("lf_walk_w", "gap_chain_mk", "gap_chain_mk_w") if wide else NARROW
    if min(path_counts["genome path"][k] for k in need) < 1:
        raise AssertionError("the genome path did not launch every kernel")

    # the kernels the tools ran on the genome build, against their plain
    # versions at the shapes the tools gave them (the rank rows come from
    # the memo the hand-off filled): the select visit on all of
    # select_ssa's lanes, the verify and harvest walks on checkbwt's and
    # the SA/ISA walk's lanes (and through the 64-bit form on the same rows
    # widened)
    gsel = None if wide else select_compare(bwtg, want_ranks, "genome path",
                                            sweep=True)
    lf_genome = lf_compare(bwtg, text, "genome path",
                           ("sector",) if wide else ("sector", "sector_w"),
                           ("verify_walk", "harvest_walk"), wide=wide,
                           sample=PLAIN_SAMPLE)
    lf_genome_w = lf_genome.pop("sector_w", None)
    if gidx:
        gidx = index_compare(gidx, "genome path")

    lap("11c")
    # ---- 11c. the genome path's PLCP ------------------------------------
    # compute_sa_device (the LF-walk kernel's harvest visit at rate 1 over
    # the build's rows), compute_plcp_device (one launch of the Kasai
    # kernel), the device encoder and the PLB1 writer; then 2^20 positions
    # held to the memory-mapped text, the .lcpbit read back at them, and
    # the kernel against its plain version on a sample of lanes
    glcp = None
    if ng < 1 << 31:
        table = np.zeros(256, np.uint8)
        table[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
        dense_g = table[text]
        lcpbit_g = inpg + ".lcpbit"
        glcp = {}
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def genome_plcp():
            t0 = time.monotonic()
            sa_dev, _n = compute_sa_device(bwtg, device=dev)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            plcp_dev = lp.compute_plcp_device(dense_g, 4, sa_dev, device=dev)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            nbits, by = lp.encode_plcp_bits_device(plcp_dev)
            t3 = time.monotonic()
            lp.write_plcp_bytes(lcpbit_g, ng, nbits, by)
            t4 = time.monotonic()
            glcp.update(sa=sa_dev, plcp=plcp_dev, wall={
                "compute_sa_device": t1 - t0, "compute_plcp_device": t2 - t1,
                "encode_plcp_bits_device": t3 - t2,
                "write_plcp_bytes": t4 - t3})
            return 0

        run_tool("genome PLCP: compute_sa_device, compute_plcp_device, "
                 "encode, write", [], fn=genome_plcp)
        path_counts["genome LCP path"] = counts()
        peak_glcp = torch.cuda.max_memory_allocated()
        say("genome LCP path launches: %s; steps, wall s: %s; peak device "
            "memory %.3f GiB [%s]"
            % (path_counts["genome LCP path"],
               {k: round(v, 3) for k, v in glcp["wall"].items()},
               peak_glcp / 2 ** 30, smi))
        if min(path_counts["genome LCP path"][k]
               for k in ("kasai", "lf_walk")) < 1:
            raise AssertionError("the genome PLCP did not launch the LF-walk "
                                 "and Kasai kernels")
        sa_dev, plcp_dev = glcp.pop("sa"), glcp.pop("plcp")
        # 2^20 positions against the text: PLCP[p] = l where rotations p
        # and q = SA[ISA[p] - 1] share l symbols and differ after them
        rng = np.random.default_rng(args.seed + 15)
        ps = np.unique(rng.integers(0, ng, 1 << 20))
        ps_dev = torch.from_numpy(ps).to(dev)
        mark = torch.zeros(ng, dtype=torch.bool, device=dev)
        mark[ps_dev] = True
        ranks = torch.nonzero(mark[sa_dev]).squeeze(1)
        del mark
        order = torch.argsort(sa_dev[ranks])
        ranks = ranks[order]
        if not np.array_equal(sa_dev[ranks].cpu().numpy(), ps):
            raise AssertionError("the SA does not hold every position once")
        qs = torch.where(ranks > 0, sa_dev[(ranks - 1).clamp(min=0)], -1)
        ls = plcp_dev[ps_dev].long().cpu().numpy()
        ranks, qs = ranks.cpu().numpy(), qs.cpu().numpy()
        t0 = time.monotonic()
        mm = np.memmap(inpg, np.uint8, mode="r")
        bad = int(((ranks == 0) & (ls != 0)).sum())
        live = np.flatnonzero(ranks > 0)
        ar = np.arange(64)
        off = 0
        while len(live):
            idx = (ps[live, None] + off + ar) % ng
            jdx = (qs[live, None] + off + ar) % ng
            ok = (mm[idx] == mm[jdx]) | (off + ar >= ls[live, None])
            bad += int((~ok.all(axis=1)).sum())
            live = live[ls[live] > off + 64]
            off += 64
        end = np.flatnonzero((ranks > 0) & (ls < ng))
        bad += int((mm[(ps[end] + ls[end]) % ng]
                    == mm[(qs[end] + ls[end]) % ng]).sum())
        t_check = time.monotonic() - t0
        fresh = start_checkbwt(inpg, bwtg)
        t0 = time.monotonic()
        dec_vals = lp.PLCPBitDecoder(lcpbit_g, n=ng).get(ps)
        t_dec = time.monotonic() - t0
        finish_checkbwt(fresh, "genome path", ", beside the .lcpbit "
                        "read-back")
        say("genome PLCP: %d positions against the text (max l %d, %.3f s "
            "on the host): %d wrong; the .lcpbit read back at them (%.3f s): "
            "%s" % (len(ps), int(ls.max()), t_check, bad, t_dec,
                    "equal" if np.array_equal(dec_vals, ls) else "DIFFERENT"))
        if bad or not np.array_equal(dec_vals, ls):
            raise AssertionError("the genome PLCP fails its check against "
                                 "the text or its .lcpbit")
        del dec_vals, mm
        # the kernel at the path's shapes (every lane, timed, with the
        # steps it took), at 2^15 to 2^18 lanes, and against its plain
        # version on PLAIN_SAMPLE lanes cut to PLAIN_SAMPLE[1] steps
        words, phi, p0, bits = lp.device_walk_arrays(dense_g, 4, sa_dev)
        del sa_dev
        with uncounted():
            kasai_lanes = {}
            for lanes in (1 << 15, 1 << 16, 1 << 17, 1 << 18):
                p, pend = lp._lane_bounds(0, ng, lanes, dev)
                out, k_ms = timed(lambda: kasai_run(words, phi, p0, p, pend,
                                                    ng, 0, bits), reps=2)
                steps = int(out[3].sum())
                if not torch.equal(out[0], plcp_dev):
                    raise AssertionError("the Kasai walk depends on its "
                                         "lanes")
                kasai_lanes[lanes] = {"ms": k_ms, "steps": steps}
                say("kernel kasai, genome path n=%d, %d lanes: %.3f ms, %d "
                    "steps (%.2f G steps/s) [%s]"
                    % (ng, lanes, k_ms, steps, steps / k_ms / 1e6, smi))
                if lanes == lp.LANES:
                    main_k = (p, pend, k_ms, steps)
                del out
            p, pend, k_ms, steps = main_k
            pick = torch.from_numpy(np.linspace(
                0, len(p) - 1, PLAIN_SAMPLE[0]).astype(np.int64)).to(dev)
            kern = kasai_run(words, phi, p0, p[pick], pend[pick], ng, 0,
                             bits, PLAIN_SAMPLE[1])
            plain, p_ms = timed(lambda: kasai_run(
                words, phi, p0, p[pick], pend[pick], ng, 0, bits,
                PLAIN_SAMPLE[1], plain=True), warm=False)
            err = kasai_err(kern, plain)
            del kern, plain
        b_ms, b_by = kasai_bound(words, ng, steps)
        say("kernel kasai, genome path (n=%d, %d lanes, %d steps): "
            "max_abs_err %d against the plain version on %d lanes of %d "
            "steps, kernel %.3f ms (%.2f G steps/s), plain %.3f ms, bound "
            "%.3f ms (%s) [%s]"
            % (ng, len(p), steps, err, PLAIN_SAMPLE[0], PLAIN_SAMPLE[1],
               k_ms, steps / k_ms / 1e6, p_ms, b_ms, b_by, smi))
        if err:
            raise AssertionError("the Kasai kernel disagrees with its plain "
                                 "version on the genome path")
        glcp.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, steps=steps, lanes=len(p), n=ng,
                    plain_on={"lanes": PLAIN_SAMPLE[0],
                              "steps_at_most": PLAIN_SAMPLE[1]},
                    by_lanes=kasai_lanes, peak_device_bytes=peak_glcp,
                    checked_positions=len(ps))
        del words, phi, plcp_dev, dense_g, ps_dev
        torch.cuda.empty_cache()
    else:
        say("genome path: n >= 2^31, no PLCP (compute_sa_device and "
            "compute_plcp take n < 2^31, as in the reference)")

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
    replay, replay_w = [], []
    mem = {"peak": 0, "sorts": [], "levels": []}
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
        rec, rec_w = replay_level(self, "genome build")
        replay.append(rec)
        if rec_w:
            replay_w.append(rec_w)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()   # the replay's buffers

    def spy_pairs(ctx, pairs):
        base = fresh_peak()
        out = orig_pairs(ctx, pairs)
        mem["levels"].append((len(pairs), used(base),
                              merge_scaled.level_bytes_estimate(
                                  pairs, ctx.sigma, ctx.bits, wide=any(
                                      merge_scaled._is_wide(l, r)
                                      for l, r in pairs))))
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

    lap("13")
    # ---- 13. alphabets past 256 symbols ---------------------------------
    text = None
    alpha = None
    if args.alphabet_n:
        alpha = alphabet_path(args.alphabet_n, args.alphabet_mem,
                              args.alphabet32_n, args.alphabet32_mem)

    lap("14")
    # ---- 14. the index path ----------------------------------------------
    ipath = index_path(args.index_n) if args.index_n else None

    lap("11b")
    # ---- 11b. the human-genome path --------------------------------------
    human = {"phases": {}}
    if args.human_n:
        human = human_path(args.human_n, args.human_mem, args.human_hostmem,
                           args.human_bwtonly, args.human_checks)
    if args.human_n >= 1 << 31:
        say("human-genome path: n >= 2^31, no PLCP (compute_sa_device and "
            "compute_plcp take n < 2^31, as in the reference)")

    lap("15")
    # ---- 15. the sharded paths -------------------------------------------
    sym8, _bits8 = compact.read_compact(keep8["compact"])
    sharded = sharded_path(keep5, np.asarray(sym8, np.uint8), keep8)
    del sym8

    lap("12")
    # ---- 12. report -----------------------------------------------------
    say_tools()
    say("sharded step: %.3f s; (a) engine=sharded build %.3f s, its "
        "checkbwt %.3f s; from the spawn to the results (b) 2 ranks %.3f s, "
        "(c) 3 ranks %.3f s, beside (a) [%s]"
        % (sharded["step_s"], sharded["a_build_s"], sharded["a_checkbwt_s"],
           sharded["b_ranks_s"], sharded["c_ranks_s"], smi))
    for name, (wall, dev_s, span_s) in sorted(merge_phases.items(),
                                              key=lambda kv: -kv[1][0]):
        say("merge build phase %-18s wall %.3f s, device busy %s, device "
            "span %s [%s]" % (name, wall, "%.3f s" % dev_s if dev_s
                              else "not measured", "%.3f s" % span_s
                              if span_s else "not measured", smi))
    for label, phases in (("genome build", genome_phases),
                          ("forced-wide merge build", wide_phases),
                          ("human-genome build", human["phases"])):
        for name, (wall, dev_s, _span) in sorted(phases.items(),
                                                  key=lambda kv: -kv[1][0]):
            say("%s phase %-18s wall %.3f s, device busy %s [%s]"
                % (label, name, wall, "%.3f s" % dev_s if dev_s
                   else "not measured", smi))
    say("peak device memory: single-block path %.3f GiB, its LCP tools "
        "%.3f GiB, merge path %.3f GiB, genome path (build, checkbwt and the "
        "SA tools) %.3f GiB, its PLCP %.3f GiB, human-genome build %.3f GiB, "
        "path %.3f GiB [%s]"
        % (peak_single / 2 ** 30, peak_lcp_single / 2 ** 30,
           peak_merge / 2 ** 30, peak_genome / 2 ** 30,
           (glcp or {}).get("peak_device_bytes", 0) / 2 ** 30,
           human.get("peak_build", 0) / 2 ** 30,
           human.get("peak", 0) / 2 ** 30, smi))
    for sigma, rec in sorted(RANK_ALL.items()):
        say("rank_all_symbols_batch (torch, no hand kernel), wavelet rows "
            "n=2^22 sigma=%d: %s [%s]" % (sigma, json.dumps(rec), smi))
    if alpha:
        alphabet_report(alpha)
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.rmtree(TEXTS, ignore_errors=True)
    kernels = []
    for name, per_layout, extra in (
            ("lf_walk", lf_merge,
             {"layouts_single_block_path": lf_single,
              "layouts_genome_path": lf_genome,
              "layouts_human_genome_path": human.get("lf")}),
            ("gap_chain", gc,
             {"entry": "bwt_gap_chain_mk, one merge per launch",
              "root_full_length_ms": full,
              "root_recording_ms_by_log2_lanes": by_lanes}),
            ("gap_chain_mk", gmk,
             {"entry": "bwt_gap_chain_mk, the genome build's levels",
              "human_genome_levels": human.get("levels")}),
            ("lf_walk_select", gsel,
             {"human_genome_path": human.get("select")}),
            ("lf_walk_w", lf_wide,
             {"entry": "bwt_lf_walk_w, the 64-bit form",
              "narrow_form_ms": lf_merge["sector"]["ms"],
              "doctored_2^22": W22["lf_walk_w"],
              "genome_path_rows_widened": lf_genome_w,
              "human_genome_path_rows_widened": human.get("lf_w")}),
            ("gap_chain_mk_w", gcw,
             {"entry": "bwt_gap_chain_mk_w, the 64-bit form, at the root "
              "merge of the 400M build",
              "narrow_form_ms": gc["sector"]["ms"],
              "doctored_2^22": W22["gap_chain_mk_w"],
              "genome_levels_of_one_merge_rows_widened": replay_w,
              "human_genome_levels_of_one_merge_rows_widened":
              human.get("levels_w")})):
        if per_layout is None:     # select_ssa stops at 2^32 symbols
            continue
        main = per_layout["sector"]       # the layout the path ran
        groups = [per_layout] + [v for v in extra.values()
                                 if isinstance(v, (dict, list))]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": path_counts[ROW_PATH[name]][name],
            "shapes_of": ROW_PATH[name],
            "launches_by_path": {p: c[name]
                                 for p, c in path_counts.items()},
            "max_abs_err": max(errors_in(groups)),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "layout": "sector", "layouts": per_layout,
            **extra})
    kernels.append(power_kernel(power))
    if glcp:        # the genome path's PLCP ran (n < 2^31)
        kernels.append({
            "name": "kasai", "route": "cuda", "source": KERNELS["kasai"][0],
            "replaces": KERNELS["kasai"][1],
            "launches": path_counts[ROW_PATH["kasai"]]["kasai"],
            "shapes_of": ROW_PATH["kasai"],
            "launches_by_path": {p: c["kasai"]
                                 for p, c in path_counts.items()},
            "max_abs_err": max([glcp["max_abs_err"]]
                               + list(errors_in(kasai_22))),
            "ms": glcp["ms"], "plain_ms": glcp["plain_ms"],
            "plain_on": glcp["plain_on"], "bound_ms": glcp["bound_ms"],
            "bound_by": glcp["bound_by"], "library_ms": None,
            "steps": glcp["steps"], "lanes": glcp["lanes"], "n": glcp["n"],
            "ms_by_lanes": glcp["by_lanes"], "wall_s": glcp["wall"],
            "peak_device_bytes": glcp["peak_device_bytes"],
            "cases_2^22": kasai_22})
    if alpha:
        kernels.extend(alphabet_kernels(alpha))
    if gidx or ipath:
        others = {"cases_2^22": idx22, "index_path": ipath,
                  "alphabet_path_locate": (alpha or {}).get(
                      "16", {}).get("locate"),
                  "alphabet32_path_locate": (alpha or {}).get(
                      "32", {}).get("locate"),
                  "forced_wide_400M_locate": fw_locate}
        kernels.extend(index_kernels(gidx or ipath, others, {
            "genome_path": gidx, **others}))
    return finish(kernels)


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_started()
