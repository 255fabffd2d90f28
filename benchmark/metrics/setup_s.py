"""Set-up: from the process's start to the first timed scan (imports, the
CUDA context, the kernels from their build cache or built, the pool of
scans made from the seed, the warm-up over every shape the window uses)."""


def read(run):
    return run.setup_s
