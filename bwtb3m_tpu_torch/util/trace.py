"""The port's tracer: named spans, kept in memory.

``span(name, **attrs)`` is a context manager that records one span:
(id, parent id, root id, name, start ns, end ns, attrs).  The parent is
the innermost span open on the same thread, the root the outermost, so
every span of one request (``engine.build``, ``engine.ssa``,
``apps.align``) carries its root's id.  The start and end stamps are
``time.time_ns()``, the clock that ``torch.profiler`` stamps its host and
device events with, so a span lines up with the profiler's trace; its
duration (``ns``, ``seconds``) comes from a ``time.monotonic_ns()`` pair
taken beside them, so a step of the wall clock cannot bend it.  While a
profiler session
is active a span also opens ``record_function("bwtb3m::" + name)``, and
the trace names the host step; outside one it costs four clock reads and
an append.  A span never syncs the device: a span that must cover device
work ends on the caller's own sync.

Closed spans go into a ring of the last ``RING`` records; ``records``
reads them by time, ``self_ns`` gives a span's time less its children's.
Recording is always on and thread-safe; nothing is written out.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional

import torch

PREFIX = "bwtb3m::"
RING = 1 << 16


class Span:
    """One span; the context manager that records it."""

    __slots__ = ("tracer", "id", "parent", "root", "name", "start_ns",
                 "end_ns", "ns", "attrs", "_t0", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = self.ns = 0

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(
                PREFIX + self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = time.monotonic_ns() - self._t0
        self.end_ns = time.time_ns()
        self.tracer._stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self.tracer._close(self)

    def __repr__(self) -> str:
        return ("Span(%r, id=%s, parent=%s, root=%s, %d ns, %r)"
                % (self.name, self.id, self.parent, self.root, self.ns,
                   self.attrs))


class Tracer:
    def __init__(self, ring: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        return self._local.__dict__.setdefault("stack", [])

    def _close(self, rec: Span) -> None:
        with self._lock:
            self._ring.append(rec)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def records(self, lo_ns: int = 0, hi_ns: Optional[int] = None
                ) -> List[Span]:
        """The ring's spans that lie inside [lo_ns, hi_ns], in the order
        they closed."""
        with self._lock:
            got = list(self._ring)
        return [r for r in got if r.start_ns >= lo_ns
                and (hi_ns is None or r.end_ns <= hi_ns)]

    def self_ns(self, rec: Span) -> int:
        """``rec``'s duration less what its children (in the ring)
        cover."""
        with self._lock:
            kids = [r.ns for r in self._ring if r.parent == rec.id]
        return rec.ns - sum(kids)


TRACER = Tracer()
span = TRACER.span
records = TRACER.records
self_ns = TRACER.self_ns
