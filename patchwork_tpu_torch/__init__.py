"""patchwork_tpu_torch — Recursive Patchwork ground segmentation on PyTorch
with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

The port of ``patchwork_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports torch and numpy only.  Its main path is
:func:`filter_ground_batched`: binning, the level loop, and the CUDA
kernels of ``kernels/fit_cuda.py`` on a CUDA tensor (their plain PyTorch
versions on a CPU tensor).  The front ends — fusion, the API, the
processor, the streaming node, the launch descriptor and the CLI — run on
the card unless the caller passes ``device="cpu"`` (the processor and the
API's static utilities per call, NumPy in and out); without a card they
raise instead of falling back.
"""

from .api import RecursivePatchwork
from .core.config import LidarConfig, PatchworkConfig, default_lidar_configs
from .core.types import GroundResult, PointCloud, ScanBatch
from .fusion.fusion import LidarFusion
from .processor import PointCloudProcessor
from .segment.engine import (filter_ground, filter_ground_batched,
                             make_filter_ground, make_filter_ground_batched)

__all__ = ["PatchworkConfig", "LidarConfig", "default_lidar_configs",
           "PointCloud", "ScanBatch", "GroundResult", "filter_ground",
           "filter_ground_batched", "make_filter_ground",
           "make_filter_ground_batched", "RecursivePatchwork",
           "PointCloudProcessor", "LidarFusion"]
