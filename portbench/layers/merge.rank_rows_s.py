"""Seconds per build building the right regions' rank rows on the card
(phase ``rank rows`` of the build's phases line)."""
from portbench.layers._read import phase_per_build


def read(trace):
    return phase_per_build(trace, "rank rows")
