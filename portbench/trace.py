"""What a traced run (``--trace 1``) reads: the profiler's device
intervals, the host's annotations, launches of the program's hand-written
kernels timed with CUDA events, and the spans the benchmark records
around the program's layers.

Device time is the union of the intervals in which a kernel, a copy or a
set ran on the card, read from the raw events of ``torch.profiler``
(never through ``key_averages()``, whose summaries cost tens of seconds
on a build).  The window is the interval of the ``portbench::window``
annotation, so the busy share and the idle gaps are taken inside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "portbench::window"
NAMED = ("portbench::", "bwtb3m::", "span::")


def _ns(ev, what: str) -> int:
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, what + "_us")() * 1000)


def _end_ns(ev) -> int:
    fn = getattr(ev, "end_ns", None)
    if fn is not None:
        return int(fn())
    return _ns(ev, "start") + _ns(ev, "duration")


def raw_events(prof) -> list:
    """The profiler's raw events, without building its summaries."""
    return list(prof.profiler.kineto_results.events())


def split_events(events) -> Tuple[list, list]:
    """(device intervals, host annotations), each (start ns, end ns,
    name): every kernel, copy and set that ran on the card, and the
    annotations that name what the host was doing (the window, the
    program's phases, the benchmark's spans).  The profiler mirrors each
    annotation on the card's timeline; those mirrors are no device
    work and are left out."""
    dev, host = [], []
    for ev in events:
        name = ev.name()
        named = name.startswith(NAMED)
        if "CUDA" in str(ev.device_type()):
            if not named:
                dev.append((_ns(ev, "start"), _end_ns(ev), name))
        elif named:
            host.append((_ns(ev, "start"), _end_ns(ev), name))
    return dev, host


def window_of(host) -> Optional[Tuple[int, int]]:
    for s, e, name in host:
        if name == WINDOW:
            return s, e
    return None


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi), n) for s, e, n in intervals
            if e > lo and s < hi]


def merge(intervals) -> List[Tuple[int, int]]:
    """The union of ``intervals`` (start, end, ...) as disjoint sorted
    (start, end) pairs."""
    out: List[List[int]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_ns(intervals) -> int:
    return sum(e - s for s, e in merge(intervals))


def top_ops(dev, k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time, [name, s]."""
    tot: Dict[str, int] = defaultdict(int)
    for s, e, name in dev:
        tot[name] += e - s
    best = sorted(tot.items(), key=lambda x: -x[1])[:k]
    return [[name[:120], ns / 1e9] for name, ns in best]


def idle_gaps(dev, host, lo: int, hi: int, k: int = 10) -> List[list]:
    """Where the window's idle time went, [what the host was doing, s],
    the ``k`` largest: every stretch of the window in which nothing ran
    on the card, cut at the host's annotations and each piece given to
    the innermost annotation that covers it."""
    busy = merge(dev)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    spans = [(s, e, n) for s, e, n in host if n != WINDOW and e > s]
    cuts = sorted({x for s, e, _n in spans for x in (s, e)})
    import bisect
    tot: Dict[str, int] = defaultdict(int)
    for gs, ge in gaps:
        a = bisect.bisect_right(cuts, gs)
        b = bisect.bisect_left(cuts, ge)
        edges = [gs] + cuts[a:b] + [ge]
        for ps, pe in zip(edges[:-1], edges[1:]):
            if pe <= ps:
                continue
            mid = (ps + pe) // 2
            cover = [(e - s, n) for s, e, n in spans if s <= mid < e]
            tot[min(cover)[1] if cover else "outside annotations"] += pe - ps
    best = sorted(tot.items(), key=lambda x: -x[1])[:k]
    return [[name[:120], ns / 1e9] for name, ns in best]


class KernelLog:
    """Launches of the program's hand-written kernels, each timed by a
    pair of CUDA events on the launch's stream and described by the work
    it was given: (name, start event, end event, bytes, operations)."""

    def __init__(self):
        self.launches: List[tuple] = []

    def wrap(self, module, attr: str, name: str,
             work: Callable[..., Tuple[float, float]]):
        """Replace ``module.attr`` by a function that records each call;
        ``work(*args, **kw)`` gives the bytes the call has to move and
        the operations it has to do.  Returns an undo function, or None
        when the module has no such function."""
        import torch
        orig = getattr(module, attr, None)
        if orig is None:
            return None

        def timed(*args, **kw):
            nbytes, nops = work(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kw)
            b.record()
            self.launches.append((name, a, b, nbytes, nops))
            return out

        setattr(module, attr, timed)
        return lambda: setattr(module, attr, orig)

    def totals(self, names):
        """(device s, least s, the side that binds the most launches:
        "bytes" or "operations", launches) over the launches named in
        ``names`` whose work is counted; call after a device sync."""
        from .roofline import bound
        dev = least = 0.0
        sides = {"bytes": 0, "operations": 0}
        k = 0
        for name, a, b, nbytes, nops in self.launches:
            if name in names and (nbytes or nops):
                dev += a.elapsed_time(b) / 1e3
                t, side = bound(nbytes, nops)
                least += t
                sides[side] += 1
                k += 1
        return dev, least, max(sides, key=sides.get), k


class Spans:
    """Seconds spent in named parts of the program's calls, summed over
    the window, timed by the benchmark around those calls (each ended on
    a device sync when ``sync``).  Each span is also kept as a host
    annotation, (start ns, end ns, ``portbench::<name>``) on the clock of
    the profiler's timestamps, for a trace that records no host events."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.intervals: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t0 = time.monotonic()
        s0 = time.time_ns()
        with torch.profiler.record_function("portbench::" + name):
            try:
                yield
            finally:
                if self.sync is not None:
                    self.sync()
                self.seconds[name] += time.monotonic() - t0
                self.calls[name] += 1
                self.intervals.append((s0, time.time_ns(),
                                       "portbench::" + name))

    def wrap(self, module, attr: str, name: str):
        """Time every call of ``module.attr`` as the span ``name``;
        returns an undo function, or None when it is gone."""
        orig = getattr(module, attr, None)
        if orig is None:
            return None

        def timed(*args, **kw):
            with self(name):
                return orig(*args, **kw)

        setattr(module, attr, timed)
        return lambda: setattr(module, attr, orig)
