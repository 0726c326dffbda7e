"""Logging / telemetry.

Mirrors the reference's observability conventions (SURVEY.md section 5.1/5.5):
unstructured stderr logging with ``[V]``/``[W]``/``[E]`` prefixes
(e.g. upstream src/bwtb3m.cpp:65 style ``MemUsage`` + runtime print),
``RealTimeClock`` spans around phases, memory telemetry, and a background
tmp-dir size monitor (``SizeMonitorThread``, upstream src/lcpbit.cpp:3838).
"""

from __future__ import annotations

import os
import resource
import sys
import threading
import time
from typing import Optional


class RealTimeClock:
    """Wall-clock span timer (reference ``RealTimeClock`` behaviour)."""

    def __init__(self):
        self.start()

    def start(self) -> None:
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def __enter__(self) -> "RealTimeClock":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        pass


def mem_usage_string() -> str:
    """Peak RSS telemetry string (reference ``MemUsage`` analog)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is KiB on Linux
    return "MemUsage(rss=%.2fMB)" % (ru.ru_maxrss / 1024.0)


class VerboseLog:
    """Leveled stderr logger with ``[V]``/``[W]``/``[E]``/``[M]`` prefixes."""

    def __init__(self, verbose: int = 1, stream=None):
        self.verbose = verbose
        self.stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()

    def _emit(self, prefix: str, msg: str) -> None:
        with self._lock:
            self.stream.write("[%s] %s\n" % (prefix, msg))
            self.stream.flush()

    def v(self, msg: str, level: int = 1) -> None:
        if self.verbose >= level:
            self._emit("V", msg)

    def w(self, msg: str) -> None:
        self._emit("W", msg)

    def e(self, msg: str) -> None:
        self._emit("E", msg)

    def m(self, msg: str) -> None:
        self._emit("M", msg)

    def span(self, name: str):
        return _LogSpan(self, name)


class _LogSpan:
    def __init__(self, log: VerboseLog, name: str):
        self.log = log
        self.name = name
        self.rtc = RealTimeClock()

    def __enter__(self):
        self.log.v("%s..." % self.name)
        self.rtc.start()
        return self

    def __exit__(self, *exc):
        self.log.v("%s done in %.3fs" % (self.name, self.rtc.elapsed()))


def dir_size_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class SizeMonitor:
    """Background thread sampling a directory's size (reference
    ``SizeMonitorThread`` samples tmp-dir size every 5 s,
    upstream src/lcpbit.cpp:3838,3920-3921)."""

    def __init__(self, path: str, interval: float = 5.0):
        self.path = path
        self.interval = interval
        self.peak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.peak = max(self.peak, dir_size_bytes(self.path))
            except OSError:
                pass

    def __enter__(self) -> "SizeMonitor":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        try:
            self.peak = max(self.peak, dir_size_bytes(self.path))
        except OSError:
            pass
