"""From the benchmark handing a scan to the node (at its due time or
after) to that scan's result at the sink, median ms over the frames of
the window (the benchmark's own stamps); the p95 goes to stderr."""

import sys

from benchmark import arith


def read(run):
    if run.arrival != "open":
        return None
    ms = [1e3 * (run.arrived[k] - h) for k, h in enumerate(run.handed)
          if k in run.arrived]
    if not ms:
        return None
    print(f"# node_result_ms.live: p95 {arith.percentile(ms, 95.0)} ms over "
          f"{len(ms)} frames", file=sys.stderr)
    return arith.median(ms)
