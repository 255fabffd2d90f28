"""Multi-process execution on ``torch.distributed``: a (dp, sp) mesh of
ranks, scan-sharded and point-sharded engines, the explicit-collective
engine.  Counterpart of ``patchwork_tpu/parallel`` (its ``P`` has none:
PyTorch has no ``PartitionSpec``; :func:`scan_batch_sharding` returns the
functions that cut and join a batch instead)."""

from .mesh import (DATA_AXIS, POINT_AXIS, make_mesh, replicated,
                   scan_batch_sharding)
from .multihost import host_summary, initialize_multihost, is_multihost
from .sharded import (
    make_sharded_filter_ground,
    make_sharded_pipeline,
    make_shardmap_fused,
)
from .shardmap_engine import make_shardmap_patchwork

__all__ = ["DATA_AXIS", "POINT_AXIS", "make_mesh", "replicated",
           "scan_batch_sharding", "host_summary", "initialize_multihost",
           "is_multihost", "make_sharded_filter_ground",
           "make_sharded_pipeline", "make_shardmap_fused",
           "make_shardmap_patchwork"]
