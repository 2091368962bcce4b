"""Means over the window's jobs, for the per-layer readers."""


def mean_timing(ctx, kind: str, key: str):
    """The mean of a job's ``timings[key]`` in ms over the window's jobs
    that completed, for jobs of ``kind``; None otherwise."""
    vals = [j.timings[key] for j in ctx.jobs if j.ok and key in j.timings]
    if ctx.kind != kind or not vals:
        return None
    return sum(vals) / len(vals) * 1e3


def idle_share(ctx, kind: str):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if ctx.kind != kind or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
