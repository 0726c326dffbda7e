"""Named phase timing for the engine.

``Phases(device)("name")`` is a context manager that adds the phase's
wall time (ended by a device sync, so it covers the phase's device work)
to ``wall["name"]``, exclusive of phases nested inside it.  Each phase is
a span ``name`` of the tracer (``util/trace.py``), which under
``torch.profiler`` annotates it as ``bwtb3m::name``: the benchmark's
traces name idle stretches by it, and ``chip_smoke.py`` sums the device
time under each label from ``key_averages()``.  The build logs ``wall``
as its ``phases (wall s): {json}`` line.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import trace


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
        span = trace.span(name)
        try:
            with span:
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            dt = span.seconds
            stack.pop()
            if stack:
                stack[-1][0] += dt
            with self._lock:
                self.wall[name] = self.wall.get(name, 0.0) + dt - frame[0]
