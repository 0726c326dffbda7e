"""Milliseconds per 1,000 reads writing the SAM records (MD tags, record
text, writes): the program's span ``apps.emit``, one a chunk of reads,
over the ``reads`` of the ``apps.align`` root spans that lie inside the
traced window (in the alignment's split trace, its profiled part: the
emit launches nothing, so the profiler does not slow it)."""

ROOT, SPAN = "apps.align", "apps.emit"


def read(trace):
    try:
        from bwtb3m_tpu_torch.util import trace as tracer
    except ImportError:             # a program without the tracer
        return None
    recs = tracer.records(*trace.job.window_ns)
    reads = {r.id: r.attrs.get("reads", 0) for r in recs
             if r.name == ROOT and r.parent is None}
    got = [r.ns for r in recs if r.name == SPAN and r.root in reads]
    if not got or not sum(reads.values()):
        return None
    return sum(got) / 1e6 / (sum(reads.values()) / 1e3)
