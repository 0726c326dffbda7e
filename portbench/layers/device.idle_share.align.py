"""Share of the window in which nothing ran on the card: 100 x (1 - the
union of the device's intervals in the profiler's trace over the
window's wall time)."""
from portbench.layers._read import idle_share


def read(trace):
    return idle_share(trace)
