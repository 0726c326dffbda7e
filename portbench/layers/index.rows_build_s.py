"""Seconds per ``bwtcomputessa`` run uploading the symbols and building
the rank rows on the card, ended on a sync: the program's span
``index.rows.build``, over the ``engine.ssa`` root spans that lie
inside the traced window."""

ROOT, SPAN = "engine.ssa", "index.rows.build"


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
