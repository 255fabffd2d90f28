"""Sampling and downsampling: seeded random subsample, voxel-grid filter.

Counterpart of ``patchwork_tpu/ops/sampling.py``:

* :func:`random_subsample_mask` draws a uniform sample without replacement
  as a Gumbel top-k from an explicit ``torch.Generator`` (the reference's
  unseeded rejection loop, point_cloud_processor.cpp:122-148).  JAX's
  threefry bits are not reproduced; :func:`_topk_mask` is the scores-in
  core that both packages share.
* :func:`voxel_grid_filter` is the exact voxel centroid filter
  (point_cloud_processor.cpp:150-196): a lexicographic sort on the voxel
  coordinates, runs, and a segment sum, padded to the input capacity.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["random_subsample_mask", "voxel_grid_filter"]


def _topk_mask(scores: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the ``min(k, n_valid)`` valid points of highest score, over
    the last dim (``lax.top_k`` on scores with invalid points at -inf)."""
    k = min(k, valid.shape[-1])
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    idx = torch.topk(s, k, dim=-1).indices
    sel = torch.zeros_like(valid).scatter_(-1, idx, True)
    return sel & valid


def random_subsample_mask(valid: torch.Tensor, target_size: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Mask selecting min(target_size, n_valid) valid points uniformly
    without replacement, per row of ``valid`` (..., N).

    When fewer than ``target_size`` points are valid, all are selected (the
    reference returns its input unchanged, point_cloud_processor.cpp:124-126).
    ``generator`` lives on ``valid``'s device.
    """
    e = torch.empty(valid.shape, dtype=torch.float32, device=valid.device)
    gumbel = -torch.log(e.exponential_(generator=generator))
    return _topk_mask(gumbel, valid, target_size)


def _stable_lexsort(keys) -> torch.Tensor:
    """Permutation sorting by ``keys[0]``, then ``keys[1]``, ..., ties in
    index order: stable sorts from the last key to the first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def voxel_grid_filter(xyz: torch.Tensor, valid: torch.Tensor,
                      voxel_size: float):
    """Exact voxel-grid centroid filter with fixed-capacity output.

    Returns (centroids (N, 3), out_valid (N,)): one centroid per occupied
    voxel, voxels in lexicographic (x, y, z) order, padded with zeros to the
    input capacity.  The voxel index is floor(x / s) per axis
    (point_cloud_processor.cpp:161-163), with 1/s rounded to float32 as in
    the JAX reference.
    """
    n = xyz.shape[0]
    inv = float(np.float32(1.0 / voxel_size))
    vox = torch.floor(xyz * inv).to(torch.int32)
    big = torch.full_like(vox[:, 0], 2 ** 31 - 1)
    keys = [torch.where(valid, vox[:, i], big) for i in range(3)]
    order = _stable_lexsort(keys)
    sk = torch.stack([k[order] for k in keys], 1)
    sxyz, svalid = xyz[order], valid[order]

    same = (sk[1:] == sk[:-1]).all(dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=xyz.device),
                       ~same]) & svalid
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    run = torch.where(svalid, run, torch.full_like(run, n - 1))
    w = svalid.to(torch.float32)
    sums = torch.zeros_like(xyz).index_add_(0, run, sxyz * w[:, None])
    cnts = torch.zeros_like(w).index_add_(0, run, w)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_valid = torch.arange(n, device=xyz.device) < first.sum()
    return (torch.where(out_valid[:, None], centroids,
                        torch.zeros_like(centroids)), out_valid)
