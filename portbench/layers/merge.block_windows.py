"""Window sorts per block: the mean ``windows`` attribute of the
program's ``merge.block_sort`` spans (each pad-high confirmation and each
lookahead growth counts) under the ``engine.build`` root spans that lie
inside the traced window; a count, which repeats exactly for one seed."""

ROOT, SPAN = "engine.build", "merge.block_sort"


def read(trace):
    try:
        from bwtb3m_tpu_torch.util import trace as tracer
    except ImportError:             # a program without the tracer
        return None
    recs = tracer.records(*trace.job.window_ns)
    roots = {r.id for r in recs if r.name == ROOT and r.parent is None}
    got = [r.attrs["windows"] for r in recs
           if r.name == SPAN and r.root in roots and "windows" in r.attrs]
    if not got:
        return None
    return sum(got) / len(got)
