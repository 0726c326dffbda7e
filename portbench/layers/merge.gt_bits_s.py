"""Seconds per build in the merge engine's gt bits (phase ``gt bits
(host)`` of the build's phases line)."""
from portbench.layers._read import phase_per_build


def read(trace):
    return phase_per_build(trace, "gt bits (host)")
