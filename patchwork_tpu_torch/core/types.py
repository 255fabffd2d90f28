"""Point-cloud containers and the result of the segmentation engine.

Counterpart of ``patchwork_tpu/core/types.py``: fixed-capacity SoA
``(N, 3)`` float32 tensors with a validity mask in place of the
reference's AoS ``std::vector<Point3D>`` (include/recursive_patchwork.hpp:
18-22), and fixed-shape boolean masks over the input rows in place of its
two compacted point vectors (src/recursive_patchwork.cpp:310-426).
``ground & valid`` and ``valid & ~ground`` recover the reference's two sets
exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["PointCloud", "ScanBatch", "GroundResult", "as_xyz", "tensor_leaves"]


@dataclasses.dataclass
class PointCloud:
    """A fixed-capacity point cloud: ``xyz`` (N, 3) float32 (padding rows
    arbitrary) and ``valid`` (N,) bool, on one device."""

    xyz: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def from_numpy(pts: np.ndarray, capacity: Optional[int] = None,
                   device: torch.device | str = "cpu") -> "PointCloud":
        """Pad an (n, >=3) float array into a fixed-capacity PointCloud."""
        pts = np.asarray(pts, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] < 3:
            raise ValueError(f"expected (n, >=3) array, got {pts.shape}")
        n = pts.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")
        xyz = np.zeros((cap, 3), dtype=np.float32)
        xyz[:n] = pts[:, :3]
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True
        return PointCloud(torch.from_numpy(xyz).to(device),
                          torch.from_numpy(valid).to(device))

    def to_numpy(self) -> np.ndarray:
        """Compact back to a (n, 3) array of the valid points."""
        return self.xyz[self.valid].cpu().numpy()


@dataclasses.dataclass
class ScanBatch:
    """A batch of fixed-capacity scans: (B, N, 3) float32 + (B, N) bool,
    the input of :func:`filter_ground_batched`."""

    xyz: torch.Tensor
    valid: torch.Tensor

    @property
    def batch(self) -> int:
        return self.xyz.shape[0]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[1]

    @staticmethod
    def stack(clouds: Sequence[PointCloud]) -> "ScanBatch":
        return ScanBatch(torch.stack([c.xyz for c in clouds]),
                         torch.stack([c.valid for c in clouds]))

    def __getitem__(self, i: int) -> PointCloud:
        return PointCloud(self.xyz[i], self.valid[i])


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


def tensor_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested structure of dicts, lists, tuples and
    dataclasses, depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name))
