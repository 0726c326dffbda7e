"""How the benchmark drives bwtb3m_tpu_torch: the build options of a
configuration, a log that records the program's spans and phases, fresh
output directories, and the warm-up.  The only module of the harness,
with the jobs, that imports the program; ``reference/`` never does.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np

PHASES = "phases (wall s): "


def parse_phases(line: str) -> Optional[Dict[str, float]]:
    """The per-phase wall seconds of a ``phases (wall s): {json}`` log
    line (with or without its ``[V]`` prefix), else None."""
    at = line.find(PHASES)
    if at < 0:
        return None
    try:
        got = json.loads(line[at + len(PHASES):])
    except ValueError:
        return None
    return {str(k): float(v) for k, v in got.items()}


class SpanLog:
    """A log in the program's ``VerboseLog`` form that keeps what the
    program reports instead of printing it: each span's seconds (summed
    by name), the phases line of the build, and the last lines.  With
    ``annotate`` each span is also a ``span::<name>`` profiler
    annotation, so a trace can say what the host was doing."""

    def __init__(self, verbose: int = 1, annotate: bool = False,
                 keep: int = 200):
        self.verbose = verbose
        self.annotate = annotate
        self.lines = collections.deque(maxlen=keep)
        self.spans: Dict[str, float] = collections.defaultdict(float)
        self.phases: Dict[str, float] = {}

    def _emit(self, prefix: str, msg: str) -> None:
        self.lines.append("[%s] %s" % (prefix, msg))
        got = parse_phases(msg)
        if got is not None:
            self.phases = got

    def v(self, msg: str, level: int = 1) -> None:
        if self.verbose >= level:
            self._emit("V", msg)

    def w(self, msg: str) -> None:
        self._emit("W", msg)

    def e(self, msg: str) -> None:
        self._emit("E", msg)

    def m(self, msg: str) -> None:
        self._emit("M", msg)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch
            ctx = torch.profiler.record_function("span::" + name)
        t0 = time.monotonic()
        with ctx:
            try:
                yield self
            finally:
                self.spans[name] += time.monotonic() - t0


def span_seconds(spans: Dict[str, float], prefix: str) -> Optional[float]:
    """The seconds of the spans whose name starts with ``prefix``, or
    None when there is none."""
    got = [s for k, s in spans.items() if k.startswith(prefix)]
    return sum(got) if got else None


def undo(ctx) -> None:
    """Put back what a traced run wrapped (``ctx.undo``)."""
    for fn in getattr(ctx, "undo", []):
        if fn is not None:
            fn()


def read_bytes(path: str) -> bytes:
    """The file's bytes; none when it is missing."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return b""


def fresh_dir(path: str) -> str:
    """Make ``path``, which must not exist: a job never finds what an
    earlier job left (a checkpoint would let a build resume)."""
    os.makedirs(path)
    return path


def max_block_symbols(mem: int) -> int:
    """The merge engine's block: ``mem / 16`` symbols, at most 2^27, as
    the tool's options define it."""
    return min(1 << 27, max(1 << 10, mem // 16))


def build_options(config: dict, pac: str, out_dir: str, device: str,
                  mem: Optional[int] = None):
    """The ``BwtOptions`` of the configuration's build of ``pac`` into
    ``out_dir`` (its checkpoints there too)."""
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    opt = config["options"]
    return BwtOptions(
        input_path=pac, input_type=opt["inputtype"],
        output_filename=os.path.join(out_dir, "genome.bwt"),
        sa_sampling_rate=int(opt["sasamplingrate"]),
        isa_sampling_rate=int(opt["isasamplingrate"]),
        mem=int(mem or opt["mem"]), bwt_only=bool(opt["bwtonly"]),
        device=device, verbose=1)


def text_symbols(config: dict) -> int:
    """Symbols of the configuration's pacterm text: both strands and the
    terminator."""
    return 2 * int(config["genome"]["forward_bases"]) + 1


def warm_up(config: dict, traffic: dict, seed: int, tmp: str, device: str,
            then=None) -> None:
    """Build a small text through the same entry, with the options of
    the configuration and a ``mem`` that gives its text as many blocks
    as the configuration's text has, so the same engine and kernels run;
    ``then(bwt_path)`` runs after it (a job's own step)."""
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.result import clear_caches

    from .traffic import genome
    n_full = text_symbols(config)
    blocks = -(-n_full // max_block_symbols(int(config["options"]["mem"])))
    fwd = int(traffic["warmup_forward_bases"])
    rng = np.random.default_rng([seed, 7])
    forward = genome.random_bases(rng, fwd, float(config["genome"]["gc"]))
    pac = os.path.join(tmp, "warmup.pac")
    with open(pac, "wb") as f:
        f.write(genome.pack_pac(genome.both_strands(forward)))
    n = 2 * fwd + 1
    mem = 16 * -(-n // blocks) if blocks > 1 else None
    out = fresh_dir(os.path.join(tmp, "warmup"))
    res = compute_bwt(build_options(config, pac, out, device, mem=mem),
                      log=SpanLog())
    if then is not None:
        then(res.bwt_path)
    del res
    clear_caches()
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    os.remove(pac)
