"""Seconds per ``bwtcomputessa`` run decoding the ``.bwt`` on the host for
its rank rows: the program's span ``index.rows.decode`` (inside
``BwtResult.load_focc``), over the ``engine.ssa`` root spans that lie
inside the traced window."""

ROOT, SPAN = "engine.ssa", "index.rows.decode"


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
