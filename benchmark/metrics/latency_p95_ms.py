"""95th-percentile latency of the frames due in the window, open loop: from each
scan's due time on the sensor's schedule to its result at the benchmark's
sink, host clock.  A frame with no result counts as missing every limit."""

from benchmark import arith

Q = 95.0


def read(run):
    if run.due is None:
        return None
    lat = [1e3 * (run.arrived[k] - d) if k in run.arrived else float("inf")
           for k, d in enumerate(run.due)]
    value = arith.percentile(lat, Q)
    return None if value == float("inf") else value
