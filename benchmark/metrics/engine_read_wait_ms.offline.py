"""Host ms a batch spent waiting for the card inside engine calls: the
"engine.read" spans' total over the window, over the engine calls in it
(``node.times``, the program's spans)."""


def read(run):
    if (run.arrival != "closed" or "engine.read" not in run.stages
            or run.engine_calls == 0):
        return None
    return run.stages["engine.read"]["total_ms"] / run.engine_calls
