"""Batch segmentation over a (dp, sp) mesh of processes.

Counterpart of ``patchwork_tpu/parallel/sharded.py``.  Every function here
takes the global batch, identical on every rank, and returns the global
``GroundResult`` on every rank (a JAX result is a global array).

* **Whole scans per rank** (:func:`make_shardmap_fused`): scans are
  independent, so each dp rank runs ``filter_ground_batched`` on its B/dp
  scans with the configuration's own kernels (the level path, kernel #1,
  or ``fit_level``, kernel #5, above the path gate) and an ``all_gather``
  over dp puts the masks together.  An sp axis of size > 1 repeats the work
  on each of its ranks, as in the JAX package.
* **Points sharded** (:func:`make_sharded_filter_ground` and
  :func:`make_sharded_pipeline` with ``shard_points``): the JAX package has
  XLA's partitioner split the engine's segment ops over sp
  (sharded.py:79-109), with per-node arrays replicated and O(nodes)
  collective traffic a step.  PyTorch has no partitioner, so the port does
  the same by hand: each rank takes its (B/dp, N/sp) block of the batch and
  runs binning and the generic levels on those points alone, with the
  segment impl forced as sharded.py:100-102 forces it.  Every per-node
  statistic is the rank's partial, reduced over the sp group through a
  ``segops.Ranks`` bound to it (``mesh.ranks_over``): sums and counts by
  ``mesh.ordered_sum`` (the same bits on every rank), bounding boxes and
  the deficient fallback's (z, global index) minima by MIN, and the split
  median and percentile seeds by kernel #2's per-round entry, each of its
  five histogram rounds summed over sp (``mesh.all_sum``; integer counts,
  so the same key on every rank).  Every branch and loop bound is read
  from reduced values.  What crosses between ranks is per-node blocks,
  never points; the one per-point collective is the final join of the
  masks.

The forced impl: the JAX package takes ``segment_impl`` or its
``default_impl(gspmd=True)``, "onehot" on a TPU and "scatter" elsewhere
(segops.py:42-54), and turns "fused" into "onehot" because a
``pallas_call`` cannot be partitioned.  The port's counterparts, by the
device of the batch: on the card "pallas", the kernel segment ops (#6 over
each binding's plan, #7, #8), whose sums add in a fixed order (the port's
"onehot" is ``index_add_``, float atomics in no fixed order on a CUDA
tensor); on the CPU "scatter", the JAX package's CPU choice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import PatchworkConfig
from ..core.types import GroundResult
from ..segment.engine import filter_ground_batched
from ..segment.segops import default_impl
from .mesh import POINT_AXIS, axis_index, ranks_over, scan_batch_sharding

__all__ = ["make_sharded_filter_ground", "make_sharded_pipeline",
           "make_shardmap_fused", "point_sharded_impl"]


def _use_fused_shardmap(cfg: PatchworkConfig, shard_points: bool) -> bool:
    """Route whole-scan-per-rank execution through the fused engine."""
    impl = cfg.segment_impl or default_impl()
    return (not shard_points) and impl == "fused"


def point_sharded_impl(cfg: PatchworkConfig, device: torch.device) -> str:
    """The segment impl of the point-sharded path (module docstring)."""
    impl = cfg.segment_impl or default_impl()
    if impl == "fused":
        impl = "pallas" if device.type == "cuda" else "scatter"
    return impl


def _counts(res: GroundResult):
    ground_cnt = res.ground.sum(-1, dtype=torch.int32)
    nong_cnt = (res.valid & ~res.ground).sum(-1, dtype=torch.int32)
    return ground_cnt, nong_cnt


def _join_masks(join, res: GroundResult) -> GroundResult:
    """One collective for the four (B, N) masks of a block."""
    packed = join(torch.stack([res.ground, res.valid, res.in_zone,
                               res.in_patch], -1))
    return GroundResult(*packed.unbind(-1))


def make_shardmap_fused(cfg: PatchworkConfig, mesh, with_counts: bool = False):
    """dp-sharded batched engine, the configuration's fused kernels on each
    rank's B/dp scans.

    fn(xyz (B, N, 3), valid (B, N)) -> GroundResult of (B, N) masks (plus
    per-scan (B,) int32 ground and non-ground counts when
    ``with_counts``).  B must divide over dp; an sp axis of size > 1
    repeats the work on each of its ranks (prefer sp = 1)."""
    return _sharded(cfg, mesh, False, with_counts, impl="fused")


def _sharded(cfg: PatchworkConfig, mesh, shard_points: bool,
             with_counts: bool, impl: Optional[str] = None):
    """Cut the batch, run ``filter_ground_batched`` on this rank's block
    with segment impl ``impl`` (None: :func:`point_sharded_impl` by the
    batch's device), join the masks.  With ``shard_points`` the block holds
    N/sp points of each scan and every per-node statistic crosses the sp
    group (module docstring)."""
    layout = scan_batch_sharding(mesh, shard_points)
    group = mesh.get_group(POINT_AXIS) if shard_points else None
    j = axis_index(mesh, POINT_AXIS)

    def fn(xyz: torch.Tensor, valid: torch.Tensor):
        xb, vb = layout.cut(xyz), layout.cut(valid)
        ranks = ranks_over(group, j * xb.shape[1]) if shard_points else None
        res = filter_ground_batched(xb, vb, cfg.replace(
            segment_impl=impl or point_sharded_impl(cfg, xyz.device)),
            ranks=ranks)
        res = _join_masks(layout.join, res)
        return (res, *_counts(res)) if with_counts else res

    return fn


def make_sharded_filter_ground(cfg: PatchworkConfig, mesh,
                               shard_points: bool = True):
    """(B, N) batched engine over the mesh.

    fn(xyz (B, N, 3), valid (B, N)) -> GroundResult of (B, N) masks.  With
    ``shard_points=False`` and the fused impl (the default) it is
    :func:`make_shardmap_fused`; otherwise the point-sharded path of the
    module docstring (points over sp when ``shard_points``)."""
    if _use_fused_shardmap(cfg, shard_points):
        return make_shardmap_fused(cfg, mesh)
    return _sharded(cfg, mesh, shard_points, with_counts=False)


def make_sharded_pipeline(cfg: PatchworkConfig, mesh,
                          shard_points: bool = True):
    """Segmentation plus the per-scan summary: fn(xyz, valid) ->
    (GroundResult, ground counts (B,), non-ground counts (B,)), the counts
    the reference's node publishes (recursive_patchwork_node.cpp:159-221).
    Routes as :func:`make_sharded_filter_ground`."""
    if _use_fused_shardmap(cfg, shard_points):
        return make_shardmap_fused(cfg, mesh, with_counts=True)
    return _sharded(cfg, mesh, shard_points, with_counts=True)
