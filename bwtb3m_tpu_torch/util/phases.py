"""Named phase timing for the engine.

``Phases(device)("name")`` is a context manager that adds the phase's
wall time (ended by a device sync, so it covers the phase's device work)
to ``wall["name"]``, exclusive of phases nested inside it, and marks the
span ``bwtb3m::name`` for ``torch.profiler``: a profiled run reads each
phase's device time from ``key_averages()`` under that label.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

PREFIX = "bwtb3m::"


class Phases:
    def __init__(self, device):
        self.device = torch.device(device)
        self.wall: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def __call__(self, name: str):
        stack = self._local.__dict__.setdefault("stack", [])
        frame = [0.0]             # wall time of the phases nested inside
        stack.append(frame)
        t0 = time.monotonic()
        try:
            with torch.profiler.record_function(PREFIX + name):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            dt = time.monotonic() - t0
            stack.pop()
            if stack:
                stack[-1][0] += dt
            with self._lock:
                self.wall[name] = self.wall.get(name, 0.0) + dt - frame[0]
