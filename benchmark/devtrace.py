"""One ``torch.profiler`` window over a stretch of a run, reduced to what
the per-layer readers and the ``breakdown`` need.

Only device rows count as device time (``DeviceType.CUDA``: kernels,
copies and sets): the host-side row of a PyTorch op carries its kernels'
device time as its own, so summing every row would count it twice (the
rule of ``patchwork_tpu_torch/core/timing.device_busy_ms``).  Busy time is
the union of the device rows' intervals.  An idle gap is named by what
the host was doing at its middle: the innermost span the harness opened
(``bench.*``, ``node.*``) and the innermost other host event.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import arith

__all__ = ["Kernel", "TraceSummary", "DeviceTrace", "summarize",
           "short_name", "label_gaps"]

SPAN_PREFIXES = ("bench.", "node.")
TOP = 10


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One device operation's rows, summed by name."""

    name: str
    seconds: float
    count: int


@dataclasses.dataclass
class TraceSummary:
    kernels: List[Kernel]     # every device row by name, most time first
    busy_s: float             # union of the device rows' intervals
    window_s: float           # the traced window on the host's clock
    gaps: List[Tuple[str, float]]   # idle seconds by what the host did

    def seconds_matching(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and rows of the operations whose name matches
        any of ``patterns`` (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        hit = [k for k in self.kernels if any(r.search(k.name) for r in rx)]
        return sum(k.seconds for k in hit), sum(k.count for k in hit)

    def breakdown(self) -> dict:
        return {"device_ops": [[short_name(k.name), k.seconds]
                               for k in self.kernels[:TOP]],
                "idle_gaps": [[name, s] for name, s in self.gaps[:TOP]]}


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def label_gaps(gaps: Sequence[Tuple[float, float]],
               host: Sequence[Tuple[str, float, float]]
               ) -> List[Tuple[str, float]]:
    """Idle seconds summed by what the host was doing at each gap's
    middle, most first.  ``gaps``: (start, end) in µs; ``host``: (name,
    start, end) host events in µs on the same clock."""
    if not gaps:
        return []
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    is_span = np.array([n.startswith(SPAN_PREFIXES) for n in names], bool)
    out: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = (starts <= mid) & (ends > mid)
        parts = []
        for pick in (cover & is_span, cover & ~is_span):
            idx = np.nonzero(pick)[0]
            if len(idx):
                parts.append(names[idx[np.argmax(starts[idx])]])
        out[" > ".join(parts) or "python"] += (e - s) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce a profiler's events (``prof.events()``) to a summary."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # the device-side copy of a host span is no device operation
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(SPAN_PREFIXES)):
                dev.append((ev.name, tr.start, tr.end))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, tr.start, tr.end))
    totals: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, s, e in dev:
        totals[name][0] += (e - s) / 1e6
        totals[name][1] += 1
    kernels = sorted((Kernel(n, t, c) for n, (t, c) in totals.items()),
                     key=lambda k: -k.seconds)
    intervals = [(s, e) for _, s, e in dev]
    busy = arith.busy_seconds(intervals) / 1e6
    if host:
        lo = min(min(h[1] for h in host), min((s for s, _ in intervals),
                                              default=np.inf))
        hi = max(max(h[2] for h in host), max((e for _, e in intervals),
                                              default=-np.inf))
        gaps = label_gaps(arith.idle_gaps(intervals, lo, hi), host)
    else:
        gaps = []
    return TraceSummary(kernels, busy, window_s, gaps)


class DeviceTrace:
    """A profiler window that a run opens and closes at chosen points:
    ``start()`` and ``stop()`` drain ``device`` first, so the window holds
    whole operations.  The events are reduced only when ``summary()`` is
    first asked for, after the measured window."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._closed = None       # (profiler, window seconds)
        self._summary: Optional[TraceSummary] = None
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        self._closed = self._summary = None

    def stop(self) -> None:
        self._sync()
        window = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        self._closed = (prof, window)

    def summary(self) -> Optional[TraceSummary]:
        """The last closed window, reduced; None if none was closed."""
        if self._summary is None and self._closed is not None:
            prof, window = self._closed
            self._summary = summarize(prof.events(), window)
        return self._summary
