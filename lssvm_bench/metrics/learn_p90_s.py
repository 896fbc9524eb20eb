"""90th percentile of every learn's host seconds in the window (each learn
ends in a read of its result on the host)."""

import statistics


def read(ctx):
    times = ctx["call_s"]
    return statistics.quantiles(times, n=10)[-1] if len(times) >= 10 else None
