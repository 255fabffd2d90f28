"""Device ms a frame of the level path's kernels over the profiled
stretch of frames, the kernels matched by the patterns of
``level_path_device_ms.offline``."""

import pathlib

from benchmark.manifest import load_module

PATTERNS = load_module(pathlib.Path(__file__).with_name(
    "level_path_device_ms.offline.py")).PATTERNS


def read(run):
    if run.arrival != "open" or run.trace is None or run.traced_calls == 0:
        return None
    seconds, rows = run.trace.seconds_matching(PATTERNS)
    return 1e3 * seconds / run.traced_calls if rows else None
