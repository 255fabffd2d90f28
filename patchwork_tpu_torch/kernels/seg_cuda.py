"""Hand-written CUDA kernels of the ``"pallas"`` segment-op backend, with
their plain PyTorch versions.

Port of ``patchwork_tpu/kernels/seg_pallas.py`` (sources in
``patchwork_tpu_torch/csrc/``); ``SegOps(impl="pallas")`` in
``segment/segops.py`` calls them.

==============  ====================================================
family          replaces (patchwork_tpu/kernels/...)
==============  ====================================================
``seg_sum``     seg_pallas.py ``seg_sum_pallas`` / ``_seg_sum_kernel``
``seg_gather``  seg_pallas.py ``seg_gather_pallas`` / ``_gather_kernel``
``seg_minmax``  seg_pallas.py ``seg_minmax_pallas`` / ``_minmax_kernel``
==============  ====================================================

All three are in csrc/seg.cu.  ``seg_sum`` is :func:`.fit_cuda.seg_sum`,
the fixed-order segment sum binning also uses; ``seg_gather`` and
``seg_minmax`` are exact, so kernel and plain version agree bit for bit in
any order.  A segment binding (``SegOps``) builds :func:`seg_plan` of its
ids once on the card and hands it to each of its sums.
As in :mod:`.fit_cuda`, a wrapper takes its plain version only for a CPU
tensor, and launches its kernel (or raises) for a CUDA tensor; launches
count into ``fit_cuda.LAUNCHES``.

:func:`run_sum` (csrc/seg.cu) replaces no TPU kernel: it is the in-order
sum of the voxel-grid filter's runs, which the JAX package leaves to XLA
and for which PyTorch on the card offers only ``index_add_``'s atomics.
"""

from __future__ import annotations

import types

import torch

from ..segment.segops import f32_key, flatten_batch, key_f32
from .fit_cuda import (LAUNCHES, _f32, _gather_rows, _launch, _on_card,
                       _workspace, seg_plan, seg_sum, seg_sum_plain)

__all__ = ["LAUNCHES", "plain", "seg_plan", "seg_sum", "seg_gather",
           "seg_minmax", "run_sum"]

_KEY_POS_INF = 0x7F800000                   # f32_key(+inf)
_KEY_NEG_INF = -0x7F800001                  # f32_key(-inf)


def _check_seg(seg: torch.Tensor, b: int, n: int) -> None:
    if seg.dtype != torch.int32:
        raise TypeError("seg must be int32")
    if seg.shape != (b, n):
        raise ValueError(f"seg must be ({b}, {n}), got {tuple(seg.shape)}")


# ---------------------------------------------------------------------------
# seg_gather  (seg_pallas.py:100-128 seg_gather_pallas -> _gather_kernel)
# ---------------------------------------------------------------------------

def seg_gather_plain(table, seg):
    return _gather_rows(table, seg)


def seg_gather(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-point lookup ``out[b, c, i] = table[b, c, seg[b, i]]``.

    table (B, C, S) f32, seg (B, N) int32 in [0, S) -> (B, C, N).  CUDA:
    bound by the per-point traffic (4 bytes of id in, 4 C bytes out), so a
    thread moves four consecutive points with 16-byte loads and stores and
    reads the scan's table from shared memory, staged once per block of
    1024 points (from the read-only cache when it exceeds 48 KB); one point
    per access where N is not a multiple of 4.
    """
    if not _on_card(table, seg):
        return seg_gather_plain(table, seg)
    _f32(table)
    b, c, s = table.shape
    n = seg.shape[1]
    _check_seg(seg, b, n)
    out = table.new_empty((b, c, n))
    if n:
        _launch("seg_gather", "pw_seg_gather", (table, seg, out), b, c, n, s)
    return out


# ---------------------------------------------------------------------------
# seg_minmax  (seg_pallas.py:135-199 seg_minmax_pallas -> _minmax_kernel)
# ---------------------------------------------------------------------------

def seg_minmax_plain(vals, seg, mask, num_segs):
    b, c, n = vals.shape
    idx = flatten_batch(seg, num_segs)[:, None].expand(-1, c)
    key = f32_key(vals).permute(0, 2, 1).reshape(b * n, c)
    m = mask.reshape(b * n, 1)

    def reduce(fill, how):
        src = torch.where(m, key, torch.full_like(key, fill))
        out = torch.full((b * num_segs, c), fill, dtype=torch.int32,
                         device=vals.device)
        out = out.scatter_reduce_(0, idx, src, how)
        return key_f32(out.reshape(b, num_segs, c).permute(0, 2, 1))

    return reduce(_KEY_POS_INF, "amin"), reduce(_KEY_NEG_INF, "amax")


def seg_minmax(vals: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
               num_segs: int):
    """Masked per-segment min and max of C channels in one pass.

    vals (B, C, N) f32, seg (B, N) int32 in [0, num_segs), mask (B, N) bool
    -> (mins, maxs), each (B, C, num_segs); +inf / -inf for empty segments.
    Values compare as order-preserving int keys, so -0.0 orders below +0.0.

    CUDA, one launch, exact in any order; the keys are kept as distances
    from the identity (+inf's key for a min, -inf's for a max), so a zeroed
    scratch that the kernel zeroes again serves every call: no fill
    launch.  A block takes a chunk of 2048 points of a scan into a shared
    table (global memory where it exceeds 48 KB), updates the scan's table
    once per touched entry, and the last block of a scan writes its
    results.  A warp whose live lanes hold one node (points in azimuth
    order) combines their keys in one warp reduction and updates once, any
    other warp lane by lane.  A segment binding calls it without its plan:
    a version over the plan was slower on every input measured (PERF.md).
    """
    if not _on_card(vals, seg, mask):
        return seg_minmax_plain(vals, seg, mask, num_segs)
    _f32(vals)
    b, c, n = vals.shape
    _check_seg(seg, b, n)
    if mask.dtype != torch.bool or mask.shape != (b, n):
        raise ValueError("mask must be (B, N) bool")
    out = torch.empty((2, b, c, num_segs), dtype=torch.float32,
                      device=vals.device)
    ws = _workspace(vals.device, b * (2 * c * num_segs + 1))
    _launch("seg_minmax", "pw_seg_minmax",
            (vals, seg, mask, ws, out[0], out[1]), b, c, n, num_segs)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# run_sum: sums of runs of consecutive rows in row order (no TPU kernel)
# ---------------------------------------------------------------------------

def run_sum_plain(rows, first, live, run):
    n, c = rows.shape
    sums = torch.zeros_like(rows)
    cnts = rows.new_zeros(n)
    starts = torch.nonzero(first).flatten()
    if starts.numel() == 0:
        return sums, cnts
    stops = torch.nonzero(first | ~live).flatten()
    nxt = torch.searchsorted(stops, starts, right=True)
    end = torch.where(nxt < stops.numel(),
                      stops[torch.clamp(nxt, max=stops.numel() - 1)],
                      torch.full_like(starts, n))
    length = end - starts
    acc = rows.new_zeros(starts.numel(), c)
    for t in range(int(length.max())):      # the runs' t-th rows, together
        m = length > t
        acc[m] = acc[m] + rows[starts[m] + t]
    dst = run[starts].to(torch.int64)
    sums[dst] = acc
    cnts[dst] = length.to(rows.dtype)
    return sums, cnts


def run_sum(rows: torch.Tensor, first: torch.Tensor, live: torch.Tensor,
            run: torch.Tensor):
    """Sums of runs of consecutive rows, each added in row order from +0.0.

    rows (N, C) f32, C <= 4; first (N,) bool marks the row a run starts at
    (a live one); live (N,) bool: a run goes on while the next row is live
    and starts no run; run (N,) int32: at a run's first row, the index its
    sum goes to.  Returns (sums (N, C), counts (N,) f32), zero where no run
    lands.  The order is fixed, so the card gives the same bits run after
    run, and the bits of a sequential sum on the CPU.

    CUDA: one thread per row; the thread of a run's first row walks its
    run.  Bound by the longest run; the rows are read once.
    """
    if not _on_card(rows, first, live, run):
        return run_sum_plain(rows, first, live, run)
    _f32(rows)
    n, c = rows.shape
    if not 1 <= c <= 4:
        raise ValueError("run_sum takes 1..4 columns")
    if first.dtype != torch.bool or live.dtype != torch.bool:
        raise TypeError("first and live must be bool")
    if run.dtype != torch.int32:
        raise TypeError("run must be int32")
    if first.shape != (n,) or live.shape != (n,) or run.shape != (n,):
        raise ValueError("first, live and run must be (N,)")
    sums = torch.zeros_like(rows)
    cnts = rows.new_zeros(n)
    if n:
        _launch("run_sum", "pw_run_sum", (rows, first, live, run, sums, cnts),
                n, c)
    return sums, cnts


# The plain versions under the wrappers' names (SegOps(..., plain=True)).
plain = types.SimpleNamespace(seg_sum=seg_sum_plain,
                              seg_gather=seg_gather_plain,
                              seg_minmax=seg_minmax_plain,
                              run_sum=run_sum_plain)
