"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, judged by the cell's own check.  Not run by the
benchmark's runs; run on the card at a cell's own size, on three seeds
or more, to read the upper end of each limit:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

- builds and ``bwtcomputessa``: the guarantee is an exact suffix order;
  the control sorts the rotations by their first ``DEPTH`` symbols only
  (a shortened sort, ties by position) and writes every file from that;
- alignment: the guarantee is every position within ``maxmis``
  substitutions; the control reports those within ``maxmis - 1``.

Prints, per seed, each compared number of the cell as the control reads
it beside its limit, and what differs (BWT symbols, reads).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEPTH = 64          # symbols the shortened sort compares (rounded up)
CALLS = 8           # alignment calls a seed: a 30 s window's worth


def preisa_rate(n: int, isa_rate: int) -> int:
    """A ``.preisa`` rate: a power of two near n / 2^17, within
    [32, ``isa_rate``]."""
    target = max(1, n // (1 << 17))
    rate = 1 << max(5, (target - 1).bit_length())
    return max(1, min(min(rate, max(32, isa_rate)), n))


def write_files(out_dir: str, text, sa, options: dict, ssa=None) -> None:
    """The files of a build (and with ``ssa`` = (sa rate, isa rate) the
    ``.sa`` / ``.isa`` of a ``bwtcomputessa``) from the suffix array
    ``sa`` of ``text``, in the formats the cell's check reads."""
    import numpy as np
    import torch

    from portbench.reference import files, sa as rsa
    n = len(text)
    bwt = rsa.bwt_of(text, sa)
    isa = rsa.inverse(sa)
    put = {"bwt": files.rlb1_bytes(bwt, 5),
           "hist": files.hist_bytes(np.bincount(text.cpu().numpy(),
                                                minlength=5))}
    prate = preisa_rate(n, int(options["isasamplingrate"]))
    pos = torch.arange(0, n, prate, device=text.device)
    pairs = torch.stack([isa[pos], pos], 1).cpu().numpy().astype("<u8")
    put["preisa"] = pairs.tobytes()
    put["preisa.meta"] = np.array([prate, len(pairs)], "<u8").tobytes()
    rates = ssa or ((int(options["sasamplingrate"]),
                     int(options["isasamplingrate"]))
                    if not int(options["bwtonly"]) else None)
    if rates:
        put["sa"] = files.sampled_bytes(rates[0], sa[::rates[0]])
        put["isa"] = files.sampled_bytes(rates[1], isa[::rates[1]])
    if not int(options["bwtonly"]):
        put["hwt"] = files.hwt_bytes(bwt, 5)
    for ext, data in put.items():
        with open(os.path.join(out_dir, "genome." + ext), "wb") as f:
            f.write(data)


def build_control(config: dict, seed: int, tmp: str, device: str,
                  ssa: bool = False) -> dict:
    """The cell's numbers as the shortened sort's files read."""
    import torch

    from portbench.jobs import build as bjob, ssa as sjob
    from portbench.reference import sa as rsa
    from portbench.traffic import genome
    forward, _shares = genome.forward_strand(config["genome"], seed)
    text_np = genome.pacterm_symbols(forward)
    text = torch.from_numpy(text_np).to(device)
    short = rsa.suffix_array(text, 5, max_depth=DEPTH)
    out = os.path.join(tmp, "control_%d" % seed)
    os.makedirs(out)
    rates = None
    if ssa:
        rates = (int(config["ssa"]["sasamplingrate"]),
                 int(config["ssa"]["isasamplingrate"]))
    write_files(out, text, short, config["options"], ssa=rates)
    sa = rsa.suffix_array(text, 5)
    differ = int((rsa.bwt_of(text, sa) != rsa.bwt_of(text, short)).sum())
    del sa, short, text
    ctx = _ctx(config, seed, device, forward)
    ctx.err = sys.stdout
    ctx.runs = ctx.builds = [{"dir": out}]
    got = (sjob if ssa else bjob).check(ctx)
    return got, "BWT symbols that differ: %d of %d" % (differ, len(text_np))


def _ctx(config, seed, device, forward, traffic=None):
    import types
    return types.SimpleNamespace(config=config, seed=seed, device=device,
                                 forward=forward, traffic=traffic)


def align_control(config: dict, traffic: dict, seed: int, calls: int,
                  tmp: str, device: str):
    """The cell's numbers when each call's SAM is the reference's at
    ``maxmis - 1``."""
    import torch

    from portbench.jobs import align as ajob
    from portbench.reference.align import KmerIndex, sam_records
    from portbench.traffic import genome, reads
    forward, _shares = genome.forward_strand(config["genome"], seed)
    text = genome.both_strands(forward)
    index = KmerIndex(torch.from_numpy(text).to(device))
    ctx = _ctx(config, seed, device, forward, traffic)
    ctx.err = sys.stdout
    ctx.calls = []
    for call in range(calls):
        names, codes = reads.sample_reads(forward, traffic, seed, call)
        recs = sam_records(index, names, codes, int(traffic["maxmis"]) - 1)
        sam = os.path.join(tmp, "control_%d_%d.sam" % (seed, call))
        with open(sam, "w") as f:
            f.write("\n".join(ajob.expected_header(len(text))) + "\n")
            for nm in names:
                f.write("\n".join(recs[nm]) + "\n")
        ctx.calls.append((call, sam))
    del index
    return ajob.check(ctx), "%d calls of %d reads" % (
        calls, int(traffic["reads_per_call"]))


def main(argv=None) -> int:
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    spec = harness.load_spec()
    _work, config, traffic = harness.find_cell(spec, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="portbench_control_") as tmp:
            if traffic["job"] == "align":
                got, what = align_control(config, traffic, seed, CALLS, tmp,
                                          "cuda")
            else:
                got, what = build_control(config, seed, tmp, "cuda",
                                          ssa=traffic["job"] == "ssa")
        fails = [k for k, (v, lim) in got.items() if v > lim]
        print("control %s seed %d: %s; %s; fails %s (%.1f s)" % (
            args.workload, seed, ", ".join("%s=%s (limit %s)" % (k, v, lim)
                                           for k, (v, lim) in got.items()),
            what, ",".join(fails) or "NOTHING", time.monotonic() - t0),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
