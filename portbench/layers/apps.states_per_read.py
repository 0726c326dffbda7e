"""Search states stepped per read (``hamdna.FRONTIER["stepped"]`` over
the window's reads): a count, which repeats exactly for one seed."""


def read(trace):
    stepped = getattr(trace.job, "stepped", None)
    if stepped is None or not trace.work:
        return None
    return stepped / trace.work
