"""Seconds per build writing the ``.bwt`` (phase ``write .bwt``)."""
from portbench.layers._read import phase_per_build


def read(trace):
    return phase_per_build(trace, "write .bwt")
