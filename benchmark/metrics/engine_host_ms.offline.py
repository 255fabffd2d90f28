"""The node's "engine" stage (the engine call with its host reads, one a
level), median ms a batch over the window: ``node.times``, the program's
host span."""


def read(run):
    if run.arrival != "closed" or "engine" not in run.stages:
        return None
    return run.stages["engine"]["p50_ms"]
