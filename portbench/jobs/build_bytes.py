"""Builds of the configuration's byte text, back to back: each one
``compute_bwt`` (``inputtype=bytestream``) from the text on disk to the
last file closed, into an output directory of its own (its checkpoints
there too), after the program's result memos are cleared, as a fresh run
of ``bwtb3m`` starts.  The text is the protein text of
``portbench/traffic/protein.py``.  Reports ``build_msym_s``: input bytes
of every build in the window per second of the window.

Checked once the window has closed: every build's ``.bwt`` (RLB1 at
sigma 256) and ``.hist`` byte for byte, and its ``.preisa`` by its pairs
(any order), against what the plain reference writes from its own suffix
array of the rotations (one number: the files wrong or missing).

The control of that check (a shortened sort's files in the program's
place, which must fail it) runs on the card on its own:

    python3 portbench/jobs/build_bytes.py --control --workload <cell> \\
        --seeds 1,2,3
"""

from __future__ import annotations

import os
import sys

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from portbench import program  # noqa: E402
from portbench.jobs import build  # noqa: E402
from portbench.traffic import protein  # noqa: E402

METRIC = "build_msym_s"
SIGMA = 256                 # a bytestream's alphabet
WARMUP_STREAM = 7           # the warm-up text's stream of the seed

run = build.run
end_to_end = build.end_to_end
trace_start = build.trace_start
trace_stop = build.trace_stop
release = build.release


def setup(ctx) -> None:
    ctx.pac = os.path.join(ctx.tmp, "proteins.txt")
    protein.write_text(ctx.pac, ctx.config["text"], ctx.seed)
    warm_up(ctx.config, ctx.traffic, ctx.seed, ctx.tmp, ctx.device)
    ctx.builds = []


def warm_up(config: dict, traffic: dict, seed: int, tmp: str,
            device: str) -> None:
    """Build a small protein text through the same entry, with the
    options of the configuration and a ``mem`` that gives it as many
    blocks as the configuration's text has, so the same engine and
    kernels run."""
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.result import clear_caches
    group = dict(config["text"])
    n_full = int(group["text_bytes"])
    blocks = -(-n_full // program.max_block_symbols(
        int(config["options"]["mem"])))
    group["text_bytes"] = n = int(traffic["warmup_text_bytes"])
    path = os.path.join(tmp, "warmup.txt")
    protein.write_text(path, group, seed, WARMUP_STREAM)
    # blocks are whole multiples of 256 symbols
    mem = 16 * 256 * -(-n // (256 * blocks)) if blocks > 1 else None
    out = program.fresh_dir(os.path.join(tmp, "warmup"))
    compute_bwt(program.build_options(config, path, out, device, mem=mem),
                log=program.SpanLog())
    clear_caches()
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    os.remove(path)


def expected_files(text, sa) -> dict:
    """What the reference writes for the byte ``text`` (a torch uint8
    tensor) from the rotation order ``sa``: file extension -> bytes, and
    the ISA under ``"isa_full"`` for the ``.preisa`` check."""
    from portbench.reference import files, sa as rsa
    hist = np.bincount(text.cpu().numpy(), minlength=SIGMA)
    return {"bwt": files.rlb1_bytes(rsa.bwt_of(text, sa), SIGMA),
            "hist": files.hist_bytes(hist), "isa_full": rsa.inverse(sa)}


def _text(ctx):
    import torch
    return torch.from_numpy(np.fromfile(ctx.pac, np.uint8)).to(ctx.device)


def check(ctx) -> dict:
    """One number, the wrong or missing files of the window's builds
    (limit 0); by extension on standard error."""
    from portbench.reference import sa as rsa
    text = _text(ctx)
    want = expected_files(text, rsa.suffix_array(text, SIGMA))
    del text
    wrong = {"bwt": 0, "hist": 0, "preisa": 0}
    for b in ctx.builds:
        for ext, bad in build.compare_build(b["dir"], want).items():
            wrong[ext] += bad
    ctx.err.write("[portbench] wrong files of %d builds: %s\n" % (
        len(ctx.builds), ", ".join("%s %d" % kv for kv in sorted(
            wrong.items()))))
    return {"files_wrong": (sum(wrong.values()), 0)}


# ---------------------------------------------------------------- control

def write_files(out_dir: str, text, sa, isa_rate: int) -> None:
    """The files of a build from the rotation order ``sa`` of the byte
    ``text``, in the formats the check reads."""
    import torch

    from portbench import control
    n = len(text)
    put = expected_files(text, sa)
    isa = put.pop("isa_full")
    prate = control.preisa_rate(n, isa_rate)
    pos = torch.arange(0, n, prate, device=text.device)
    pairs = torch.stack([isa[pos], pos], 1).cpu().numpy().astype("<u8")
    put["preisa"] = pairs.tobytes()
    put["preisa.meta"] = np.array([prate, len(pairs)], "<u8").tobytes()
    for ext, data in put.items():
        with open(os.path.join(out_dir, "genome." + ext), "wb") as f:
            f.write(data)


def build_control(config: dict, seed: int, tmp: str, device: str):
    """(the cell's numbers, what differs) when the files are the plain
    reference's from rotations sorted by their first ``control.DEPTH``
    symbols only, ties by position."""
    import io
    import types

    from portbench import control
    from portbench.reference import sa as rsa
    ctx = types.SimpleNamespace(config=config, seed=seed, device=device,
                                err=io.StringIO(),
                                pac=os.path.join(tmp, "proteins_%d.txt"
                                                 % seed))
    protein.write_text(ctx.pac, config["text"], seed)
    text = _text(ctx)
    short = rsa.suffix_array(text, SIGMA, max_depth=control.DEPTH)
    out = os.path.join(tmp, "control_%d" % seed)
    os.makedirs(out)
    write_files(out, text, short, int(config["options"]["isasamplingrate"]))
    sa = rsa.suffix_array(text, SIGMA)
    differ = int((rsa.bwt_of(text, sa) != rsa.bwt_of(text, short)).sum())
    n = len(text)
    del sa, short, text
    ctx.builds = [{"dir": out}]
    got = check(ctx)
    return got, "BWT symbols that differ: %d of %d; %s" % (
        differ, n, ctx.err.getvalue().strip())


def main(argv=None) -> int:
    import argparse
    import tempfile
    import time

    from portbench import harness
    p = argparse.ArgumentParser(description="the control of a byte-text "
                                "build cell's check")
    p.add_argument("--control", action="store_true", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    _work, config, _traffic = harness.find_cell(harness.load_spec(),
                                                args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="portbench_control_") as tmp:
            got, what = build_control(config, seed, tmp, "cuda")
        fails = [k for k, (v, lim) in got.items() if v > lim]
        print("control %s seed %d: %s; %s; fails %s (%.1f s)" % (
            args.workload, seed, ", ".join("%s=%s (limit %s)" % (k, v, lim)
                                           for k, (v, lim) in got.items()),
            what, ",".join(fails) or "NOTHING", time.monotonic() - t0),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
