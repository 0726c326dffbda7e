"""Share of its roofline of the gap-chain kernel (``bwt_gap_chain_mk``
and its forms), over the window's launches: their least time at the
card's peaks over their CUDA-event time."""
from portbench.layers._read import roofline_share


def read(trace):
    return roofline_share(trace, ("chain",))
