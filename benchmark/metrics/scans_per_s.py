"""Scans per second, closed loop: the scans whose results reached the
benchmark's sink during the window, over the window's seconds.  All the
work over all the time, host clock; not a median of chunks."""

from benchmark import arith


def read(run):
    if run.arrival != "closed":
        return None
    return arith.rate(run.arrived.values(), run.t0, run.t_end)
