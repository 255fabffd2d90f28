"""The node's "h2d.pad" span (the padded host arrays: ``np.zeros`` and
the fill), median ms a batch over the window: the part of "h2d" before the
copy to the card (``node.times``, the program's span)."""


def read(run):
    if run.arrival != "closed" or "h2d.pad" not in run.stages:
        return None
    return run.stages["h2d.pad"]["p50_ms"]
