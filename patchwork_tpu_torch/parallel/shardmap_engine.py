"""Explicit-collective engine: single-level Patchwork with points sharded.

Counterpart of ``patchwork_tpu/parallel/shardmap_engine.py``.  Points
shard over the mesh's ``sp`` axis (scans over ``dp``); every per-node
statistic is a local partial on each rank, combined by explicit
collectives over sp.  That is the point-sharded engine of
:mod:`.sharded` at one level, and :func:`patchwork_level` is a call into
it: the generic level engine on this rank's points with a
``segops.Ranks`` bound to the group (``mesh.ranks_over``):
``mesh.ordered_sum`` for sums and counts (rank order, so every rank holds
the same bits), one MIN for bounding boxes and both rounds of each pick of
the lexicographic 3-lowest seed fallback, by (z, global point index).
What crosses between ranks is a (B, C, nodes) block a reduction, never
points.

The local partials are the port's segment ops over one ``SegOps(...,
"pallas")`` binding a level: on the card kernel #6 over the binding's plan
for the sums, #7 for the per-point gathers, #8 for the bounding boxes and
the fallback's minima; on the CPU their plain versions.  (The JAX
package's bf16 one-hot einsums exist only for the MXU.)  Non-finite
coordinates are zeroed before any sum.  The fit loop ends when the reduced
count of changed points is 0 or at ``max_iter``: one host read an
iteration, as the JAX package's ``while_loop``.

Restrictions (raised): ``effective_levels == 1`` and adaptive seeds, as in
the JAX package (shardmap_engine.py:58-62).
"""

from __future__ import annotations

import torch

from ..core.config import PatchworkConfig
from ..segment.engine import filter_ground_batched
from .mesh import POINT_AXIS, axis_index, ranks_over, scan_batch_sharding

__all__ = ["make_shardmap_patchwork", "patchwork_level"]


def patchwork_level(cfg: PatchworkConfig, xyz: torch.Tensor,
                    valid: torch.Tensor, shard_start: int = 0,
                    group=None) -> torch.Tensor:
    """One single-level Patchwork pass over this rank's points: xyz (B, n, 3)
    and valid (B, n), the points ``shard_start`` .. ``shard_start + n - 1``
    of each scan, the other shards on the other ranks of ``group`` (None:
    the whole scan, on this process alone).  Returns ground (B, n) bool."""
    return filter_ground_batched(
        xyz, valid, cfg.replace(max_levels=1, segment_impl="pallas"),
        ranks=ranks_over(group, shard_start)).ground


def make_shardmap_patchwork(cfg: PatchworkConfig, mesh):
    """fn(xyz (B, N, 3), valid (B, N)) -> ground (B, N) bool on every rank.

    B shards over "dp" and N over "sp"; N must divide over sp."""
    if cfg.effective_levels != 1:
        raise ValueError("shard_map engine supports single-level configs only "
                         "(use PatchworkConfig.patchwork())")
    if not cfg.adaptive_seed_height:
        raise ValueError("shard_map engine supports adaptive seeds only")
    layout = scan_batch_sharding(mesh, shard_points=True)
    group = mesh.get_group(POINT_AXIS)
    j = axis_index(mesh, POINT_AXIS)

    def fn(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        xb, vb = layout.cut(xyz), layout.cut(valid)
        return layout.join(patchwork_level(cfg, xb, vb, j * xb.shape[1],
                                           group))

    return fn
