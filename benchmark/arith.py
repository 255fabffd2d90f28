"""The benchmark's arithmetic: rates, percentiles, busy and idle shares,
and a roofline's least time, with the table of peaks they use."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["PEAKS", "rate", "percentile", "merge_intervals",
           "busy_seconds", "idle_gaps", "idle_pct", "least_seconds",
           "roofline_pct"]

# Published peaks by the name torch.cuda.get_device_name() gives: float32
# outside the tensor cores (FLOP/s) and HBM bandwidth (bytes/s), NVIDIA's
# H100 SXM data sheet, dense rates at the full 700 W.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def rate(arrivals: Iterable[float], t0: float, t_end: float) -> float:
    """Items that arrived in [t0, t_end], per second of that window."""
    return sum(1 for t in arrivals if t0 <= t <= t_end) / (t_end - t0)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q % of the values at or below it.  ``math.inf`` stands for a
    value that never came and sorts last."""
    if not values:
        raise ValueError("a percentile of no values")
    ordered = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(ordered)), 1)
    return ordered[rank - 1]


def merge_intervals(intervals: Iterable[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals: time in which at least one
    of them ran (operations on two streams at once count once)."""
    return sum(e - s for s, e in merge_intervals(intervals))


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that no interval covers."""
    gaps, at = [], start
    for s, e in merge_intervals(intervals):
        if s > at:
            gaps.append((at, min(s, end)))
        at = max(at, e)
    if end > at:
        gaps.append((at, end))
    return [(s, e) for s, e in gaps if e > s]


def idle_pct(busy_s: float, span_s: float) -> float:
    """The share of ``span_s`` in which the device ran nothing, in %."""
    return 100.0 * (1.0 - busy_s / span_s)


def least_seconds(flops: float, nbytes: float, card: str
                  ) -> Optional[Tuple[float, str]]:
    """The least time the card could take for ``flops`` float32
    operations and ``nbytes`` bytes moved, and which of the two bounds
    it; None for a card without published peaks here."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    by_ops = flops / peak["fp32_flops"]
    by_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def roofline_pct(flops: float, nbytes: float, seconds: float, card: str
                 ) -> Optional[float]:
    """The least time over the time taken, in %; None where there is no
    time or no peak to hold it to."""
    least = least_seconds(flops, nbytes, card)
    if least is None or seconds <= 0:
        return None
    return 100.0 * least[0] / seconds
