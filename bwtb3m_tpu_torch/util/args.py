"""Command-line configuration.

The reference uses two conventions (SURVEY.md section 5.6):

* ``ArgInfo``: ``key=value`` argv pairs with typed getters, defaults, and
  numeric values accepting k/m/g suffixes (reference README ``mem=``;
  upstream src/bwtb3m.cpp:44-56).
* ``ArgParser``: ``-X`` / ``-Xvalue`` flags
  (upstream src/lcpbit.cpp:3895-3901).

Both are reimplemented here behaviourally (no code taken from the reference).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Sequence

_SIZE_SUFFIX = {
    "k": 1024,
    "K": 1024,
    "m": 1024 ** 2,
    "M": 1024 ** 2,
    "g": 1024 ** 3,
    "G": 1024 ** 3,
    "t": 1024 ** 4,
    "T": 1024 ** 4,
}


def parse_size(value: str) -> int:
    """Parse an integer with an optional k/m/g/t (binary) suffix."""
    value = value.strip()
    if not value:
        raise ValueError("empty size value")
    if value[-1] in _SIZE_SUFFIX:
        return int(float(value[:-1]) * _SIZE_SUFFIX[value[-1]])
    return int(value)


class ArgInfo:
    """``key=value`` style argument container with typed getters."""

    def __init__(self, argv: Sequence[str], progname: str = "prog"):
        self.progname = progname
        self.keys: Dict[str, str] = {}
        self.restargs: List[str] = []
        for arg in argv:
            if "=" in arg and not arg.startswith("-") and not os.path.exists(arg):
                key, _, val = arg.partition("=")
                self.keys[key] = val
            else:
                self.restargs.append(arg)

    def has(self, key: str) -> bool:
        return key in self.keys

    def get(self, key: str, default: str = "") -> str:
        return self.keys.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        if key not in self.keys:
            return default
        return parse_size(self.keys[key])

    def get_float(self, key: str, default: float) -> float:
        if key not in self.keys:
            return default
        return float(self.keys[key])

    def get_bool(self, key: str, default: bool) -> bool:
        if key not in self.keys:
            return default
        return bool(int(self.keys[key]))

    def default_tmp_name(self) -> str:
        """Unique temp-file prefix ``prog_hostname_pid_time``.

        Mirrors the reference's ``ArgInfo::getDefaultTmpFileName()``
        convention (reference README options block).
        """
        return "%s_%s_%d_%d" % (
            os.path.basename(self.progname),
            socket.gethostname(),
            os.getpid(),
            int(time.time()),
        )


class ArgParser:
    """``-X`` / ``-Xvalue`` / ``--Xvalue`` flag-style parser."""

    def __init__(self, argv: Sequence[str]):
        self.flags: Dict[str, str] = {}
        self.restargs: List[str] = []
        for arg in argv:
            if arg.startswith("-") and len(arg) > 1 and not arg[1].isdigit():
                body = arg.lstrip("-")
                if "=" in body:
                    key, _, val = body.partition("=")
                    self.flags[key] = val
                else:
                    # -t4  -> key 't', value '4'; bare -test -> key 'test'
                    head = body[0]
                    tail = body[1:]
                    if tail and (tail[0].isdigit()):
                        self.flags[head] = tail
                    else:
                        self.flags[body] = ""
            else:
                self.restargs.append(arg)

    def has(self, key: str) -> bool:
        return key in self.flags

    def get(self, key: str, default: str = "") -> str:
        return self.flags.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        if key not in self.flags or self.flags[key] == "":
            return default
        return parse_size(self.flags[key])

    def __getitem__(self, key: str) -> str:
        return self.flags[key]
