"""The node's "frame" span, median ms a frame over the window: from a
frame's arrival at the node (pulled from its source) to its result built,
the program's own twin of ``node_result_ms.live`` (``node.times``)."""


def read(run):
    if run.arrival != "open" or "frame" not in run.stages:
        return None
    return run.stages["frame"]["p50_ms"]
