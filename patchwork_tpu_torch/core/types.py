"""Result container of the segmentation engine.

Counterpart of ``patchwork_tpu/core/types.py:97-124``: fixed-shape boolean
masks over the input rows instead of the reference's two compacted point
vectors (src/recursive_patchwork.cpp:310-426).  ``ground & valid`` and
``valid & ~ground`` recover the reference's two sets exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GroundResult", "as_xyz"]


@dataclasses.dataclass
class GroundResult:
    """Masks for one scan ``(N,)`` or a batch of scans ``(B, N)``."""

    ground: torch.Tensor    # bool: valid & classified ground
    valid: torch.Tensor     # bool: finite input points (reference cleanPoints)
    in_zone: torch.Tensor   # bool: valid & within filtering radius
    in_patch: torch.Tensor  # bool: valid & assigned to a ring/sector patch

    def num_ground(self) -> torch.Tensor:
        return self.ground.sum(dim=-1)

    def num_non_ground(self) -> torch.Tensor:
        return (self.valid & ~self.ground).sum(dim=-1)


def as_xyz(points, device: torch.device) -> torch.Tensor:
    """Coerce a list/ndarray of shape (n, 3) to a float32 tensor on ``device``."""
    arr = np.asarray(points, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[-1] != 3:
        raise ValueError(f"expected (n, 3), got {arr.shape}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
