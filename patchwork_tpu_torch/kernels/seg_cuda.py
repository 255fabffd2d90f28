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

``seg_sum`` is :func:`.fit_cuda.seg_sum` (csrc/sweeps.cu), the fixed-order
segment sum binning and the remap prologue already use.  ``seg_gather`` and
``seg_minmax`` are in csrc/seg.cu; both are exact, so kernel and plain
version agree bit for bit in any order.  As in :mod:`.fit_cuda`, a wrapper
takes its plain version only for a CPU tensor, and launches its kernel (or
raises) for a CUDA tensor; launches count into ``fit_cuda.LAUNCHES``.
"""

from __future__ import annotations

import types

import torch

from ..segment.segops import f32_key, flatten_batch, key_f32
from .fit_cuda import (LAUNCHES, _f32, _gather_rows, _launch, _on_card,
                       seg_sum, seg_sum_plain)

__all__ = ["LAUNCHES", "plain", "seg_sum", "seg_gather", "seg_minmax"]

_KEY_POS_INF = 0x7F800000                   # f32_key(+inf)
_KEY_NEG_INF = -0x7F800001                  # f32_key(-inf)
_MINMAX_SMEM_LIMIT = 200 * 1024


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

    table (B, C, S) f32, seg (B, N) int32 in [0, S) -> (B, C, N).  CUDA: one
    thread per point, an indexed load per channel; bound by the per-point
    traffic (4 bytes of id in, 4 C bytes out).
    """
    if not _on_card(table, seg):
        return seg_gather_plain(table, seg)
    _f32(table)
    b, c, s = table.shape
    n = seg.shape[1]
    _check_seg(seg, b, n)
    out = torch.empty((b, c, n), dtype=torch.float32, device=table.device)
    if n:
        _launch("seg_gather", "pw_seg_gather", table, seg, out, b, c, n, s)
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

    CUDA: each block reduces a chunk of one scan's points into a shared
    (2, C, S) key table with integer atomics and updates global memory once
    per touched bin; exact in any order.  Bound by the shared atomics.
    """
    if not _on_card(vals, seg, mask):
        return seg_minmax_plain(vals, seg, mask, num_segs)
    _f32(vals)
    b, c, n = vals.shape
    _check_seg(seg, b, n)
    if mask.dtype != torch.bool or mask.shape != (b, n):
        raise ValueError("mask must be (B, N) bool")
    if 2 * c * num_segs * 4 > _MINMAX_SMEM_LIMIT:
        raise ValueError(f"C={c} x num_segs={num_segs} exceeds the shared table")
    work = torch.empty((b, 2, c, num_segs), dtype=torch.int32,
                       device=vals.device)
    mins = torch.empty((b, c, num_segs), dtype=torch.float32,
                       device=vals.device)
    maxs = torch.empty_like(mins)
    _launch("seg_minmax", "pw_seg_minmax", vals, seg, mask, work, mins, maxs,
            b, c, n, num_segs)
    return mins, maxs


# The plain versions under the wrappers' names (SegOps(..., plain=True)).
plain = types.SimpleNamespace(seg_sum=seg_sum_plain,
                              seg_gather=seg_gather_plain,
                              seg_minmax=seg_minmax_plain)
