"""Seconds per build in the merge engine's block sorts (phase ``block
sorts`` of the build's phases line: the windowed doubling sorts, the
host's tie resolution and each region's derivation)."""
from portbench.layers._read import phase_per_build


def read(trace):
    return phase_per_build(trace, "block sorts")
