"""Seconds per build in the single-block sort and its host inverse (the
span ``suffix sort (single block, ...) + host inverse``)."""
from portbench.layers._read import span_per_build


def read(trace):
    return span_per_build(trace, "suffix sort (single block")
