"""Places a batch where the host waits for the card inside an engine call:
the "engine.read" spans over the window, over the engine calls in it (the
program's count)."""


def read(run):
    if (run.arrival != "closed" or "engine.read" not in run.stages
            or run.engine_calls == 0):
        return None
    return run.stages["engine.read"]["count"] / run.engine_calls
