"""Frames the node drained before its next pull, because the source paces
it, per hundred frames of the window: the "drain.paced" spans over the
"frame" spans (``node.times``, the program's count).  A program that
keeps no such span reports nothing."""


def read(run):
    if (run.arrival != "open" or "drain.paced" not in run.stages
            or not run.stages.get("frame", {}).get("count")):
        return None
    return 100.0 * run.stages["drain.paced"]["count"] / run.stages[
        "frame"]["count"]
