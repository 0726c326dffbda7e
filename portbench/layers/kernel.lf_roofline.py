"""Share of its roofline of the LF-walk kernel (``bwt_lf_walk`` and its
forms) in its final-rank, verify and harvest visits, over the window's
launches: their least time at the card's peaks over their CUDA-event
time."""
from portbench.layers._read import roofline_share


def read(trace):
    return roofline_share(trace, ("lf_walk",))
