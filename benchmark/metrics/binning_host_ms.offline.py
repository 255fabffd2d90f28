"""The engine's "engine.binning" span (patch assignment, its segment sum
and its copies in, the tau and zth rows), median host ms a batch over the
window (``node.times``, the program's span)."""


def read(run):
    if run.arrival != "closed" or "engine.binning" not in run.stages:
        return None
    return run.stages["engine.binning"]["p50_ms"]
