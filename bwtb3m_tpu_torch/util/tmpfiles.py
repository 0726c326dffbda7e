"""Temporary-file lifecycle.

Behavioural equivalents of the reference's ``TempFileNameGenerator`` and
``TempFileRemovalContainer`` (used throughout, e.g.
upstream src/hwtToRlHwt.cpp:84,97-98): generated unique tmp names under
a prefix, with registered files removed on close / interpreter exit.
"""

from __future__ import annotations

import atexit
import os
from typing import List, Set


class TempFileRemovalContainer:
    """Process-global registry of tmp files removed at exit."""

    _files: Set[str] = set()
    _registered = False

    @classmethod
    def register(cls, path: str) -> str:
        if not cls._registered:
            atexit.register(cls.cleanup)
            cls._registered = True
        cls._files.add(path)
        return path

    @classmethod
    def unregister(cls, path: str) -> None:
        cls._files.discard(path)

    @classmethod
    def cleanup(cls) -> None:
        for path in list(cls._files):
            try:
                if os.path.exists(path):
                    os.unlink(path)
            except OSError:
                pass
            cls._files.discard(path)


class TempFileNameGenerator:
    """Generates ``prefix_NNN`` names, auto-registering them for removal."""

    def __init__(self, prefix: str, register: bool = True):
        self.prefix = prefix
        self.register = register
        self.counter = 0
        self.generated: List[str] = []
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)

    def get(self, tag: str = "") -> str:
        name = "%s_%s%03d" % (self.prefix, (tag + "_") if tag else "", self.counter)
        self.counter += 1
        self.generated.append(name)
        if self.register:
            TempFileRemovalContainer.register(name)
        return name

    def cleanup(self) -> None:
        for name in self.generated:
            try:
                if os.path.exists(name):
                    os.unlink(name)
            except OSError:
                pass
            TempFileRemovalContainer.unregister(name)
        self.generated.clear()
