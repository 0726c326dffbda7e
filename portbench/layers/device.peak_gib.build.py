"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
after a reset at its start), GiB."""


def read(trace):
    if not trace.peak_bytes:
        return None
    return trace.peak_bytes / 2 ** 30
