"""Timing and lightweight metrics.

Counterpart of ``patchwork_tpu/core/timing.py``: a wall-clock Timer
(include/recursive_patchwork.hpp:90-105), a per-stage StageTimes
aggregator with percentiles, a device sync, and a profiler annotation.
:func:`sync` is ``torch.cuda.synchronize`` on each CUDA device holding a
tensor of the structure; CPU tensors need none.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .types import tensor_leaves

__all__ = ["Timer", "StageTimes", "sync", "trace_annotation"]


def sync(tree) -> None:
    """Wait for all device work producing the tensors of ``tree``."""
    for dev in {t.device for t in tensor_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer (reference Timer, hpp:90-105)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since construction / last reset."""
        return time.perf_counter() - self._t0


class StageTimes:
    """Per-stage latency aggregator with summary statistics."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def add(self, stage: str, seconds: float) -> None:
        self._samples[stage].append(seconds)

    def time(self, stage: str):
        """Context manager recording a stage's wall time."""
        outer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                outer.add(stage, time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, xs in self._samples.items():
            a = np.asarray(xs)
            out[stage] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<20} {'count':>6} {'mean':>9} {'p50':>9} {'p95':>9} {'max':>9}"]
        for stage, s in self.summary().items():
            lines.append(
                f"{stage:<20} {s['count']:>6d} {s['mean_ms']:>8.2f}m "
                f"{s['p50_ms']:>8.2f}m {s['p95_ms']:>8.2f}m {s['max_ms']:>8.2f}m"
            )
        return "\n".join(lines)


def trace_annotation(name: str):
    """A ``torch.profiler`` range (costs little when nothing traces)."""
    return torch.profiler.record_function(name)
