"""Timing and lightweight metrics.

Counterpart of ``patchwork_tpu/core/timing.py``: a wall-clock Timer
(include/recursive_patchwork.hpp:90-105), a per-stage StageTimes
aggregator with percentiles, a device sync, and a profiler annotation.
:func:`sync` is ``torch.cuda.synchronize`` on each CUDA device holding a
tensor of the structure; CPU tensors need none.  The card's clocks:
:func:`time_ms` and :func:`event_samples` (CUDA events around back-to-back
calls) and :func:`device_busy_ms` (the device time of the kernels in a
``torch.profiler`` window).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .types import tensor_leaves

__all__ = ["Timer", "StageTimes", "sync", "trace_annotation", "time_ms",
           "event_samples", "DeviceWindow", "device_busy_ms"]


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


def time_ms(fn, reps: int = 10, device=None, warm: int = 1) -> float:
    """Mean milliseconds of a call ``fn()``, after ``warm`` untimed calls:
    CUDA events around ``reps`` calls on a CUDA ``device``, the host clock
    on the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        return event_samples(fn, 1, reps, dev)[0]
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def event_samples(fn, samples: int, reps: int, device) -> List[float]:
    """Milliseconds per call of ``fn()`` in each of ``samples`` windows:
    CUDA events on ``device`` around ``reps`` back-to-back calls, the card
    drained before each window.  A CUDA device only: there is no host-clock
    stand-in for a device time."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"event_samples times a CUDA device, not {dev}")
    out = []
    for _ in range(samples):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end) / reps)
    return out


class DeviceWindow(NamedTuple):
    """Per call of a profiled window: ``busy_ms`` of device time of the
    kernels counted, ``span_ms`` of the host's clock from the first call to
    the card drained after the last, and ``kernels`` launched."""

    busy_ms: float
    span_ms: float
    kernels: float


def device_busy_ms(fn, reps: int = 1, pattern: str | None = None,
                   warm: int = 1) -> DeviceWindow:
    """Device time of ``reps`` calls of ``fn()`` under ``torch.profiler``,
    after ``warm`` untimed calls, per call.  Only the rows of CUDA kernels
    count (``DeviceType.CUDA``; with ``pattern``, those whose name matches
    it): the host-side row of a PyTorch op carries the device time of the
    kernels it launched as its own, so summing every row counts them twice.
    The profiler slows the host, so the span of this window is longer than
    that of an untimed one."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and (pattern is None or re.search(pattern, ev.key))]
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
               for ev in rows) / 1e3
    return DeviceWindow(busy / reps, span / reps,
                        sum(ev.count for ev in rows) / reps)
