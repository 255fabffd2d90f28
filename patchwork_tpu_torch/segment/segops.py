"""Segment primitives over node ids, batched over scans.

Counterpart of ``patchwork_tpu/segment/segops.py``.  ``SegOps`` binds the
(B, N) node ids of a batch of scans, each scan's ids in ``[0, num_segs)``,
and offers the segment reductions and gathers of the generic level engine
(segment/engine.py ``_level_body``, ``_child_remap``) and of the kernels'
plain versions.  Two backends:

* ``"scatter"``: ``index_add_`` and ``scatter_reduce_`` over the flattened
  batch (:func:`flatten_batch`).  On the CPU these add in point order, as
  the JAX package's CPU scatter does; on a CUDA tensor its float sums go
  through atomics in no fixed order.  ``"onehot"``, the TPU's MXU
  formulation of the same ops, is taken as this form.
* ``"pallas"``: the hand-written kernels of ``kernels/seg_cuda.py``
  (fixed-order sums, exact gathers and min/max), or their plain versions on
  a CPU tensor or with ``plain=True``.

The segment sort (:func:`sort_by_segment`) stays plain torch, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["default_impl", "IMPLS", "flatten_batch", "SegOps", "SegmentSort",
           "sort_by_segment", "f32_key", "key_f32"]

IMPLS = ("fused", "scatter", "onehot", "pallas")


def default_impl() -> str:
    """The segment-op backend when the config names none: ``"fused"`` on
    every device, so the CPU tests run the path the card runs.  (The JAX
    package picks per backend, ``"fused"`` on a TPU and ``"scatter"``
    elsewhere, segops.py:42-54.)"""
    return "fused"


def flatten_batch(seg: torch.Tensor, num_segs: int) -> torch.Tensor:
    """(B, N) per-scan ids -> (B*N,) ids in a shared ``B*num_segs`` space."""
    b = seg.shape[0]
    off = torch.arange(b, device=seg.device, dtype=torch.int64)[:, None]
    return (seg.to(torch.int64) + off * num_segs).reshape(-1)


class SegOps:
    """Segment reductions/gathers for one ``(seg (B, N), num_segs)`` binding.

    Points outside every segment must be parked on a trash id by the caller.
    Channel data is channel-first: (B, C, N) per point, (B, C, S) per
    segment; a single channel may drop its C axis.
    """

    def __init__(self, seg: torch.Tensor, num_segs: int,
                 impl: str = "scatter", plain: bool = False):
        if impl == "onehot":
            impl = "scatter"
        if impl not in ("scatter", "pallas"):
            raise ValueError(f"unknown segment impl {impl!r}")
        self.S = num_segs
        self.impl = impl
        if impl == "pallas":
            from ..kernels import seg_cuda

            self.k = seg_cuda.plain if plain else seg_cuda
            self.seg = seg.to(torch.int32).contiguous()
        else:
            self.seg = seg.to(torch.int64)
            self.flat = flatten_batch(seg, num_segs)

    # -- reductions: (B, C, N) -> (B, C, S) ------------------------------
    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if data.dim() == 2:
            return self.sum(data[:, None])[:, 0]
        if self.impl == "pallas":
            return self.k.seg_sum(data.contiguous(), self.seg, self.S)
        b, c, n = data.shape
        out = data.new_zeros((b * self.S, c)).index_add_(
            0, self.flat, data.permute(0, 2, 1).reshape(b * n, c))
        return out.reshape(b, self.S, c).permute(0, 2, 1)

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        """Integer count per segment, (B, N) -> (B, S) int32.  The "pallas"
        form counts as a float sum, exact below 2^24 points per segment."""
        if self.impl == "pallas":
            return self.sum(mask.to(torch.float32)).to(torch.int32)
        return self.sum(mask.to(torch.int32))

    def _reduce(self, vals, where, fill, how):
        b = vals.shape[0]
        src = torch.where(where, vals, torch.full_like(vals, fill))
        out = vals.new_full((b * self.S,), fill)
        return out.scatter_reduce_(0, self.flat, src.reshape(-1),
                                   how).reshape(b, self.S)

    def min(self, vals: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, S) masked min; +inf for empty segments."""
        if self.impl == "pallas":
            return self.k.seg_minmax(vals[:, None].contiguous(), self.seg,
                                     where.contiguous(), self.S)[0][:, 0]
        return self._reduce(vals, where, float("inf"), "amin")

    def max(self, vals: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, S) masked max; -inf for empty segments."""
        if self.impl == "pallas":
            return self.k.seg_minmax(vals[:, None].contiguous(), self.seg,
                                     where.contiguous(), self.S)[1][:, 0]
        return self._reduce(vals, where, float("-inf"), "amax")

    def bbox(self, xyz: torch.Tensor, where: torch.Tensor):
        """Masked min/max of (B, 3, N) x, y, z: (mins, maxs), each (B, 3, S);
        one pass under "pallas"."""
        if self.impl == "pallas":
            return self.k.seg_minmax(xyz.contiguous(), self.seg,
                                     where.contiguous(), self.S)
        mins = torch.stack([self.min(xyz[:, i], where) for i in range(3)], 1)
        maxs = torch.stack([self.max(xyz[:, i], where) for i in range(3)], 1)
        return mins, maxs

    # -- gathers: (B, C, S) -> (B, C, N) ---------------------------------
    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """Per-point lookup of a per-segment table."""
        if table.dim() == 2:
            return self.gather(table[:, None])[:, 0]
        if self.impl == "pallas":
            return self.k.seg_gather(table.contiguous(), self.seg)
        idx = self.seg[:, None, :].expand(-1, table.shape[1], -1)
        return torch.gather(table, 2, idx)

    def gather_bool(self, table: torch.Tensor) -> torch.Tensor:
        """(B, S) bool -> (B, N) bool."""
        if self.impl == "scatter":
            return torch.gather(table, 1, self.seg)
        return self.gather(table.to(torch.float32)) > 0.5


def f32_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving int32 key: flip the low 31 bits of
    negatives (-0.0 sorts just below +0.0, as in a total order)."""
    u = v.contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def key_f32(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f32_key` (the same bit trick)."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).contiguous().view(torch.float32)


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
