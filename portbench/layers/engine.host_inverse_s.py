"""Seconds per build in the single-block sort's inverse suffix array on
the host (``isa[sa] = arange(n)``): the program's span
``engine.sort.host_inverse``, over the ``engine.build`` root spans that
lie inside the traced window."""

ROOT, SPAN = "engine.build", "engine.sort.host_inverse"


def read(trace):
    try:
        from bwtb3m_tpu_torch.util import trace as tracer
    except ImportError:             # a program without the tracer
        return None
    recs = tracer.records(*trace.job.window_ns)
    roots = {r.id for r in recs if r.name == ROOT and r.parent is None}
    got = [r.ns for r in recs if r.name == SPAN and r.root in roots]
    if not got:
        return None
    return sum(got) / 1e9 / len(roots)
