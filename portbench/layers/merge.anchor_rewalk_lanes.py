"""Anchor lanes walked again per build: the sum of the ``lanes``
attribute of the program's ``merge.anchor_extend`` spans (one a round of
the anchors past their first lookback) under the ``engine.build`` root
spans that lie inside the traced window, over those roots; a count.
None where the program records no ``merge.block_sort`` span, as a
program without these spans does; 0 where it extended no anchor."""

ROOT, SPAN, SORT = "engine.build", "merge.anchor_extend", "merge.block_sort"


def read(trace):
    try:
        from bwtb3m_tpu_torch.util import trace as tracer
    except ImportError:             # a program without the tracer
        return None
    recs = tracer.records(*trace.job.window_ns)
    roots = {r.id for r in recs if r.name == ROOT and r.parent is None}
    mine = [r for r in recs if r.root in roots]
    if not any(r.name == SORT for r in mine):
        return None
    return sum(r.attrs.get("lanes", 0) for r in mine
               if r.name == SPAN) / len(roots)
