"""Milliseconds of the breadth-first search per 1,000 reads (the
benchmark's span around ``hamming_search_batch``, ended on a sync, over
the calls the profiler did not slow)."""


def read(trace):
    spans = trace.spans
    if spans is None or not spans.calls.get("search") or not spans.work:
        return None
    return spans.seconds["search"] * 1e3 / (spans.work / 1e3)
