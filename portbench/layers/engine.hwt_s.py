"""Seconds per build writing the ``.hwt`` (the span ``write .hwt``)."""
from portbench.layers._read import span_per_build


def read(trace):
    return span_per_build(trace, "write .hwt")
