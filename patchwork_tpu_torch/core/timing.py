"""Timing and lightweight metrics.

Counterpart of ``patchwork_tpu/core/timing.py``: a wall-clock Timer
(include/recursive_patchwork.hpp:90-105), the program's spans (a
:class:`StageTimes` of :class:`Span` records with parents, per-stage
percentiles and self time; :func:`span` for code that knows no node,
:func:`read` for a host wait, each a ``torch.profiler`` range while a
profiler runs), and a device sync.
:func:`sync` is ``torch.cuda.synchronize`` on each CUDA device holding a
tensor of the structure; CPU tensors need none.  The card's clocks:
:func:`time_ms` and :func:`event_samples` (CUDA events around back-to-back
calls) and :func:`device_busy_ms` (the device time of the kernels in a
``torch.profiler`` window).
"""

from __future__ import annotations

import contextvars
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .types import tensor_leaves

__all__ = ["Timer", "Span", "StageTimes", "now", "span", "current", "read",
           "READ", "sync", "time_ms", "event_samples", "DeviceWindow",
           "device_busy_ms"]


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


class Span:
    """One timed stretch of the program: ``name``, ``start`` and ``end`` on
    the ``time.perf_counter()`` clock, the ``parent`` span open around it
    (None at a root), the indices of the ``frames`` a node-level span
    served, and ``child_s``, the seconds its child spans cover.  It records
    itself into ``times`` (a :class:`StageTimes`) when it closes.

    As a context manager it is the current span of its thread while open
    (:func:`current`), so :func:`span` hangs children under it;
    :meth:`StageTimes.open` gives one that never is (it may overlap
    others).  While a ``torch.profiler`` runs, each span is also a
    ``record_function`` range named ``node.<name>``; with none running no
    range object is made.  A span reads no device value and synchronises
    nothing."""

    __slots__ = ("times", "name", "parent", "frames", "start", "end",
                 "child_s", "_range", "_cell")

    def __init__(self, times: "StageTimes", name: str, cell: list,
                 frames=(), start: float | None = None):
        self.times = times
        self.name = name
        self.parent = cell[0]
        self.frames = frames
        self.start = start
        self.child_s = 0.0
        self._range = None
        self._cell = cell

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _enter_range(self) -> None:
        self._range = torch.profiler.record_function("node." + self.name)
        self._range.__enter__()

    def _exit_range(self) -> None:
        self._range.__exit__(None, None, None)
        self._range = None

    def open(self) -> "Span":
        """Start the span: its profiler range, and its clock unless it has a
        start already."""
        if _profiling():
            self._enter_range()
        if self.start is None:
            self.start = _clock()
        return self

    def close(self, end: float | None = None) -> None:
        """End the span at ``end`` (now if None) and record it."""
        self.end = end = _clock() if end is None else end
        if self._range is not None:
            self._exit_range()
        if self.parent is not None:
            self.parent.child_s += end - self.start
        self.times.spans.append(self)

    # open() and close() inlined: a span costs about 1.5 µs of host time
    # on the card's host, and a batch opens a few dozen
    def __enter__(self) -> "Span":
        self._cell[0] = self
        if _profiling():
            self._enter_range()
        if self.start is None:
            self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = end = _clock()
        if self._range is not None:
            self._exit_range()
        self._cell[0] = self.parent
        if self.parent is not None:
            self.parent.child_s += end - self.start
        self.times.spans.append(self)
        return False


class _NoSpan:
    """What :func:`span` gives where no span is open: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


# a thread's current span, in a one-item list that the context variable
# holds: a span sets and restores the item, cheaper than the variable, and
# a new thread starts with none (contexts copied within a thread, as asyncio
# tasks are, would share it)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "patchwork_span", default=None)
_NO_SPAN = _NoSpan()
_ROOT = (None,)     # the cell of a span that is never current: no parent
_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled

# the span of each place where the host waits for the card inside an
# engine call; its count is the engine's host reads
READ = "engine.read"


def _cell() -> list:
    cell = _CURRENT.get()
    if cell is None:
        cell = [None]
        _CURRENT.set(cell)
    return cell


def now() -> float:
    """The spans' clock, ``time.perf_counter()``: a stamp taken here and a
    span's ends compare (a test's fake clock reaches both)."""
    return _clock()


def current() -> Span | None:
    """This thread's current span, or None where none is open."""
    cell = _CURRENT.get()
    return None if cell is None else cell[0]


def span(name: str):
    """A child of the current span, recorded into the :class:`StageTimes`
    that holds the current span (whichever object that is now, not one
    captured earlier); where no span is open, a context that records
    nothing."""
    cell = _CURRENT.get()
    if cell is None or cell[0] is None:
        return _NO_SPAN
    return Span(cell[0].times, name, cell)


def read(flag: torch.Tensor) -> bool:
    """``bool(flag)``: the host waits for the card to read it, so the wait
    is one :data:`READ` span, a child of the span it serves."""
    with span(READ):
        return bool(flag)


class StageTimes:
    """The spans of a program's stages, kept in memory (``spans``, in the
    order they closed), with per-stage summary statistics."""

    def __init__(self):
        self.spans: List[Span] = []

    def add(self, stage: str, seconds: float) -> None:
        """A root span of ``seconds`` timed elsewhere, ending now."""
        end = _clock()
        Span(self, stage, _ROOT, (), end - seconds).close(end)

    def time(self, stage: str, frames=(), start: float | None = None) -> Span:
        """A span of ``stage`` to open with ``with``, a child of the current
        span if one is open; ``frames``: the indices of the frames it
        serves; ``start``: a stamp already taken, where the stage began."""
        return Span(self, stage, _cell(), frames, start)

    def open(self, stage: str, frames=(), start: float | None = None) -> Span:
        """A root span of ``stage``, open now (or from ``start``) until its
        :meth:`Span.close`, that is never the current span: it may overlap
        others, as a frame's life does the next frame's stages."""
        return Span(self, stage, _ROOT, frames, start).open()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per stage: ``count``, ``mean_ms``, ``p50_ms``, ``p95_ms``,
        ``max_ms``, ``total_ms`` and ``self_ms`` (the total less what child
        spans cover)."""
        durations: Dict[str, List[float]] = defaultdict(list)
        own: Dict[str, float] = defaultdict(float)
        for s in self.spans:
            d = s.end - s.start
            durations[s.name].append(d)
            own[s.name] += d - s.child_s
        out = {}
        for stage, xs in durations.items():
            a = np.asarray(xs)
            out[stage] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_ms": float(a.sum() * 1e3),
                "self_ms": float(own[stage] * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<20} {'count':>6} {'mean':>9} {'p50':>9} "
                 f"{'p95':>9} {'max':>9} {'self':>10}"]
        for stage, s in self.summary().items():
            lines.append(
                f"{stage:<20} {s['count']:>6d} {s['mean_ms']:>8.2f}m "
                f"{s['p50_ms']:>8.2f}m {s['p95_ms']:>8.2f}m {s['max_ms']:>8.2f}m"
                f" {s['self_ms']:>9.2f}m"
            )
        return "\n".join(lines)


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
