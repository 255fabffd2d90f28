"""Kernel C calls a batch: ``kernels.fit_cuda.LAUNCHES`` summed over its
families over the window, over the engine calls in it (the program's
counter)."""


def read(run):
    if run.arrival != "closed" or run.engine_calls == 0:
        return None
    return sum(run.launches.values()) / run.engine_calls
