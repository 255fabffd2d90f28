"""Device busy ms a frame over the profiled stretch of frames: the union of
the device rows' intervals, over the frames handed to the node in it.
Less device work a frame leaves less for a frame to wait on."""


def read(run):
    if run.arrival != "open" or run.trace is None or run.traced_calls == 0:
        return None
    return 1e3 * run.trace.busy_s / run.traced_calls
