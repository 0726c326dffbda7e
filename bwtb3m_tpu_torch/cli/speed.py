"""bwttestdecodespeed: LF-step throughput of batched walks.

Port of ``bwtb3m_tpu/cli/speed.py``: the reference tool measures LF-step
throughput for 1..8 interleaved walk streams; here the stream count goes
up by eights to ``maxstreams`` lanes of the LF-walk kernel's final-rank
form (``ops/lf_walk.py::lf_walk``), from random ranks, and each count
prints one line of steps per second.  The rank rows are the wavelet rows
past 256 symbols (``bwt_lf_walk_wm``), else the fused rows.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from ..engine.result import BwtResult
from ..util.args import ArgInfo
from ..util.devices import resolve_device
from ..util.log import VerboseLog


def bwttestdecodespeed(argv: List[str]) -> int:
    from ..ops.lf_walk import lf_walk

    ai = ArgInfo(argv, "bwttestdecodespeed")
    if not ai.restargs:
        sys.stderr.write("usage: bwttestdecodespeed [steps=4096] "
                         "[maxstreams=4096] [device=cuda] <in.bwt>\n")
        return 1
    steps = ai.get_int("steps", 4096)
    maxstreams = ai.get_int("maxstreams", 4096)
    log = VerboseLog(ai.get_int("verbose", 1))
    device = resolve_device(ai.get("device", "cuda"))
    result = BwtResult.load(ai.restargs[0])
    if result.sigma > 256:
        rows, _symmap = result.load_wavelet(device, dense=True, log=log)
    else:
        rows, _symmap = result.load_focc(device, dense=True, log=log)
    n = result.n
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    b = 1
    while b <= maxstreams:
        r0 = torch.from_numpy(rng.integers(0, n, b)).to(device)
        lf_walk(rows, r0, steps)          # warm-up (loads the kernel)
        sync()
        t0 = time.monotonic()
        lf_walk(rows, r0, steps).cpu()
        dt = time.monotonic() - t0
        log.m("streams=%-8d steps=%d  %.3fs  %.3e LF-steps/s"
              % (b, steps, dt, b * steps / dt))
        b *= 8
    return 0


TOOLS = {"bwttestdecodespeed": bwttestdecodespeed}
