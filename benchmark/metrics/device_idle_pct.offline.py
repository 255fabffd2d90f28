"""The device's idle share of the profiled stretch of batches, in %:
1 - busy / span, busy the union of the device rows' intervals."""

from benchmark import arith


def read(run):
    if run.arrival != "closed" or run.trace is None:
        return None
    return arith.idle_pct(run.trace.busy_s, run.trace.window_s)
