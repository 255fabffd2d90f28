"""Segment primitives over node ids: the building blocks of the plain
versions of the kernels.

Counterpart of the ``scatter`` impl of ``patchwork_tpu/segment/segops.py``
(the exact golden path there).  ``seg`` is ``(N,)`` int in ``[0, S)``;
a batch of scans is flattened first with :func:`flatten_batch`, which
gives scan ``b`` the ids ``[b*S, (b+1)*S)``.

Float sums here go through ``index_add_``: sequential in point order on
the CPU, float atomics in no fixed order on a CUDA tensor.  Callers use
them only for integer-valued data (counts), where every order is exact;
float sums with a fixed order are ``kernels.fit_cuda.seg_sum``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["flatten_batch", "SegOps", "SegmentSort", "sort_by_segment",
           "f32_key"]


def flatten_batch(seg: torch.Tensor, num_segs: int) -> torch.Tensor:
    """(B, N) per-scan ids -> (B*N,) ids in a shared ``B*num_segs`` space."""
    b = seg.shape[0]
    off = torch.arange(b, device=seg.device, dtype=torch.int64)[:, None]
    return (seg.to(torch.int64) + off * num_segs).reshape(-1)


class SegOps:
    """Segment reductions/gathers for one ``(seg, num_segs)`` binding."""

    def __init__(self, seg: torch.Tensor, num_segs: int):
        self.seg = seg.to(torch.int64)
        self.S = num_segs

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """(N,) or (N, C) -> (S,) or (S, C)."""
        out = data.new_zeros((self.S,) + tuple(data.shape[1:]))
        return out.index_add_(0, self.seg, data)

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        """Integer count per segment."""
        return self.sum(mask.to(torch.int32))

    def min(self, vals: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
        """(N,) -> (S,) masked min; +inf for empty segments."""
        inf = torch.full_like(vals, float("inf"))
        out = torch.full((self.S,), float("inf"), dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_reduce_(0, self.seg, torch.where(where, vals, inf),
                                   "amin")

    def max(self, vals: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
        """(N,) -> (S,) masked max; -inf for empty segments."""
        ninf = torch.full_like(vals, float("-inf"))
        out = torch.full((self.S,), float("-inf"), dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_reduce_(0, self.seg,
                                   torch.where(where, vals, ninf), "amax")

    def bbox(self, xyz: torch.Tensor, where: torch.Tensor):
        """Masked min/max of x, y, z: (mins (3, S), maxs (3, S))."""
        mins = torch.stack([self.min(xyz[:, i], where) for i in range(3)])
        maxs = torch.stack([self.max(xyz[:, i], where) for i in range(3)])
        return mins, maxs

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """Per-point lookup of a per-segment table."""
        return table[self.seg]


def f32_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving int32 key: flip the low 31 bits of
    negatives (-0.0 sorts just below +0.0, as in a total order)."""
    u = v.contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


class SegmentSort(NamedTuple):
    """A (segment id, value) sort of N points, in the values' total order."""

    sorted_val: torch.Tensor   # (N,) values in (segment, value) order
    starts: torch.Tensor       # (S,) first sorted slot of each segment
    counts: torch.Tensor       # (S,) number of points per segment

    def order_stat(self, k_per_segment: torch.Tensor) -> torch.Tensor:
        """Per-segment k-th smallest value; undefined (in bounds) for empty
        segments or k >= count (callers mask those out)."""
        n = self.sorted_val.shape[0]
        pos = torch.clamp(self.starts + k_per_segment.to(torch.int64), 0,
                          max(n - 1, 0))
        return self.sorted_val[pos]


def sort_by_segment(seg: torch.Tensor, val: torch.Tensor,
                    num_segments: int) -> SegmentSort:
    """Sort by (segment id, value); ``seg`` may hold ``num_segments`` as a
    discard id for points that belong to no segment.

    Values are compared through :func:`f32_key`, which is the order the
    histogram order statistic of the kernels resolves.
    """
    seg = seg.to(torch.int64)
    key = f32_key(val).to(torch.int64) + 2 ** 31          # [0, 2^32)
    order = torch.argsort(seg * 2 ** 32 + key)
    counts = torch.bincount(seg, minlength=num_segments + 1)[:num_segments]
    starts = torch.cumsum(counts, 0) - counts
    return SegmentSort(val[order], starts, counts)
