"""What the per-layer readers share: means over the window's jobs of
what each job recorded, and kernel shares of their roofline."""

from __future__ import annotations

from typing import Iterable, Optional


def per_job(trace, values: Iterable[Optional[float]]) -> Optional[float]:
    """Seconds per job of the window: the sum of the jobs' values over
    the jobs of the window, or None when no job recorded one."""
    got = [v for v in values if v is not None]
    if not got:
        return None
    return sum(got) / trace.jobs


def phase_per_build(trace, *names: str) -> Optional[float]:
    """Seconds per build of the named ``Phases`` of the build engine."""
    builds = getattr(trace.job, "builds", [])
    return per_job(trace, (sum(b["phases"][n] for n in names
                               if n in b["phases"])
                           if any(n in b["phases"] for n in names) else None
                           for b in builds))


def span_per_build(trace, prefix: str) -> Optional[float]:
    """Seconds per build of the log spans whose name starts with
    ``prefix``."""
    from portbench.program import span_seconds
    return per_job(trace, (span_seconds(b["spans"], prefix)
                           for b in getattr(trace.job, "builds", [])))


def roofline_share(trace, names) -> Optional[float]:
    """100 x the least time over the device time of the window's
    launches named in ``names`` (None without such a launch)."""
    kernels = getattr(trace.job, "kernels", None)
    if kernels is None:
        return None
    dev, least, side, k = kernels.totals(names)
    if not k or dev <= 0:
        return None
    trace.job.err.write("[portbench] roofline of %s: %d launches, %.6f s "
                        "device, %.6f s least, bound by %s\n"
                        % ("+".join(names), k, dev, least, side))
    return 100.0 * least / dev


def idle_share(trace) -> Optional[float]:
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
