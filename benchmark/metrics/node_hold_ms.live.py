"""The node's "hold" span, median ms a frame over the window: from a
frame's engine call returning to its drain starting, while the node waits
for the next sweep to arrive (``node.times``, the program's span)."""


def read(run):
    if run.arrival != "open" or "hold" not in run.stages:
        return None
    return run.stages["hold"]["p50_ms"]
