"""Seconds per build in the merge engine's chains and anchors (phases
``chains`` and ``anchors``)."""
from portbench.layers._read import phase_per_build


def read(trace):
    return phase_per_build(trace, "chains", "anchors")
