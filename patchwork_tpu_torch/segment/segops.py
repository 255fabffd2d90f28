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
  a CPU tensor or with ``plain=True``.  On the card a binding builds the
  tile plan of its ids (``seg_cuda.seg_plan``) at its first sum or count,
  and every later one adds over it: one launch a call.  Its min, max and
  bbox take ``seg_minmax`` without the plan, the route measured faster.

The free functions :func:`seg_sum`, :func:`seg_min` and :func:`seg_max`
take one (N, ...) array and its (N,) ids, as ``jax.ops.segment_*`` do:
kernels #6 and #8 on a CUDA tensor, their plain versions on the CPU.

The segment sort (:func:`sort_by_segment`) stays plain torch, as the JAX
package leaves it to XLA.

:class:`Ranks` is what crosses the processes that hold one scan's points
between them (the point-sharded engine, ``parallel/sharded.py``): the
generic level engine reduces every per-node partial through it.  In one
process it is the identity.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import timing

__all__ = ["default_impl", "IMPLS", "flatten_batch", "seg_sum", "seg_min",
           "seg_max", "SegOps", "SegmentSort", "sort_by_segment", "f32_key",
           "key_f32", "Ranks", "ORDER_STATS"]

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


def _rows(data: torch.Tensor, seg: torch.Tensor):
    """(N, ...) float32 data, (N,) ids -> the kernels' (1, C, N) rows and
    (1, N) int32 ids."""
    if data.dtype != torch.float32:
        raise TypeError(f"expected float32 data, got {data.dtype}")
    if seg.dim() != 1 or seg.shape[0] != data.shape[0]:
        raise ValueError("seg must be (N,) with data (N, ...)")
    rows = data.reshape(data.shape[0], -1).T.contiguous()[None]
    return rows, seg.to(torch.int32)[None].contiguous()


def _unrows(out: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(C, S) per-segment rows -> (S, ...) in the trailing shape of data."""
    return out.T.reshape((out.shape[1],) + data.shape[1:])


def seg_sum(data: torch.Tensor, seg: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """Per-segment sum of (N, ...) float32 data by (N,) ids in
    [0, num_segments) -> (num_segments, ...); 0 for an empty segment.

    Kernel #6 (``fit_cuda.seg_sum``, one dense launch per 8 channels, no
    plan) on a CUDA tensor, its plain version on the CPU: both add each
    segment in the kernel's fixed order (point order inside a tile of 256
    points, then the tiles in order), which is ``jax.ops.segment_sum``'s
    point order where a segment's points lie in one tile."""
    from ..kernels import fit_cuda

    rows, ids = _rows(data, seg)
    out = torch.cat([fit_cuda.seg_sum(rows[:, c0:c0 + 8].contiguous(), ids,
                                      num_segments)[0]
                     for c0 in range(0, rows.shape[1], 8)])
    return _unrows(out, data)


def _seg_minmax(data, seg, num_segments, which):
    from ..kernels import seg_cuda

    rows, ids = _rows(data, seg)
    mask = torch.ones_like(ids, dtype=torch.bool)
    out = seg_cuda.seg_minmax(rows, ids, mask, num_segments)[which]
    return _unrows(out[0], data)


def seg_min(data: torch.Tensor, seg: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """Per-segment min of (N, ...) float32 data -> (num_segments, ...); +inf
    for an empty segment, as ``jax.ops.segment_min``.  Kernel #8
    (``seg_cuda.seg_minmax``) on a CUDA tensor, its plain version on the
    CPU; exact in any order."""
    return _seg_minmax(data, seg, num_segments, 0)


def seg_max(data: torch.Tensor, seg: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """Per-segment max, -inf for an empty segment (``jax.ops.segment_max``);
    as :func:`seg_min`."""
    return _seg_minmax(data, seg, num_segments, 1)


class SegOps:
    """Segment reductions/gathers for one ``(seg (B, N), num_segs)`` binding.

    Points outside every segment must be parked on a trash id by the caller.
    Channel data is channel-first: (B, C, N) per point, (B, C, S) per
    segment; a single channel may drop its C axis.  ``plan``: under
    ``"pallas"`` on the card, the binding's tile plan once a sum has run
    (None on the CPU and with ``plain=True``, which build none).
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
            self._card = not plain and self.seg.is_cuda \
                and self.seg.shape[1] > 0
            self.plan = None
        else:
            self.seg = seg.to(torch.int64)
            self.flat = flatten_batch(seg, num_segs)

    def _plan(self) -> dict:
        """The plan argument of a "pallas" sum: the binding's plan on the
        card, built at the first call; none elsewhere."""
        if not self._card:
            return {}
        if self.plan is None:
            self.plan = self.k.seg_plan(self.seg, self.S)
        return {"plan": self.plan}

    # -- reductions: (B, C, N) -> (B, C, S) ------------------------------
    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if data.dim() == 2:
            return self.sum(data[:, None])[:, 0]
        if self.impl == "pallas":
            return self.k.seg_sum(data.contiguous(), self.seg, self.S,
                                  **self._plan())
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
    with timing.span(timing.READ):    # the histogram's size: the host waits
        counts = torch.bincount(seg, minlength=num_segments + 1)
    counts = counts[:num_segments]
    starts = torch.cumsum(counts, 0) - counts
    return SegmentSort(val[order], starts, counts)


# order statistics taken across processes, by what they are (the split
# median, the percentile seed threshold), and the histograms they reduced
ORDER_STATS = {"median": 0, "percentile": 0, "histograms": 0}


def _identity(t):
    return t


class Ranks:
    """What crosses the processes that hold one scan's points between them.

    The generic level engine computes every per-node statistic as this
    process's partial over its own points and hands it here, to three
    reductions the caller supplies: ``sum`` of float partials (the same
    bits on every process), ``min`` elementwise, and ``histograms``, the
    sum of the order statistic's (M, 128) int32 histograms, which kernel
    #2's per-round entry reduces between its rounds.  Bounding boxes cross
    as one ``min``.  Every result is the same on every process, so every
    branch the engine takes on it is too.  ``first`` is the global index
    of this process's first point of a scan (the deficient fallback's
    ties).  ``parallel.mesh.ranks_over`` binds the three to a process
    group.  ``Ranks()``: this process holds whole scans; every reduction
    is the identity, and the order statistic is the sort by segment.
    """

    def __init__(self, sum: Optional[Callable] = None,
                 min: Optional[Callable] = None,
                 histograms: Optional[Callable] = None, first: int = 0):
        if len({sum is None, min is None, histograms is None}) > 1:
            raise ValueError("Ranks takes all three reductions or none")
        self.across = sum is not None
        self.sum = sum or _identity
        self.min = min or _identity
        self._histograms = histograms
        self.first = first

    def bbox(self, mins: torch.Tensor, maxs: torch.Tensor):
        """(mins, maxs) over every process, as one MIN of [mins, -maxs]
        (negation is exact)."""
        if not self.across:
            return mins, maxs
        lo, hi = self.min(torch.cat([mins, -maxs], 1)).chunk(2, 1)
        return lo, -hi

    def _reduce_histograms(self, hist: torch.Tensor) -> torch.Tensor:
        ORDER_STATS["histograms"] += 1
        return self._histograms(hist)

    def order_stat(self, seg: torch.Tensor, val: torch.Tensor,
                   where: torch.Tensor, k: torch.Tensor, num_segs: int,
                   need: Optional[torch.Tensor], what: str) -> torch.Tensor:
        """(B, S) k-th smallest ``val`` of each node over the points
        ``where`` of ids ``seg`` (B, N); k (B, S) from reduced counts.
        Across processes only the nodes ``need`` (B, S) are read: the others
        are not histogrammed and return 0.0.  In one process ``need`` is
        not read (None will do)."""
        b = seg.shape[0]
        if not self.across:
            ss = sort_by_segment(flatten_batch(seg, num_segs), val.reshape(-1),
                                 b * num_segs)
            return ss.order_stat(k.reshape(-1)).reshape(b, num_segs)
        from ..kernels import fit_cuda

        ORDER_STATS[what] += 1
        k = torch.where(need, k, -1).to(torch.int32)
        return fit_cuda.seg_order_stat(
            val.contiguous(), seg.to(torch.int32).contiguous(),
            where.contiguous(), k.contiguous(), num_segs,
            reduce=self._reduce_histograms)
