"""The node's "h2d" stage (pad to capacity, copy to the card), median ms
a batch over the window: ``node.times``, the program's host span."""


def read(run):
    if run.arrival != "closed" or "h2d" not in run.stages:
        return None
    return run.stages["h2d"]["p50_ms"]
