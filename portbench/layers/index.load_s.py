"""Seconds per call loading the FM index (the benchmark's span around
``BwtResult.load`` and ``FMIndex.from_bwt_result``, ended on a sync,
over the calls the profiler did not slow)."""


def read(trace):
    spans = trace.spans
    if spans is None or not spans.calls.get("index.load"):
        return None
    return spans.seconds["index.load"] / spans.jobs
