"""High-level NumPy-in / NumPy-out API mirroring the reference class surface.

Counterpart of ``patchwork_tpu/api.py:74-151``: ``RecursivePatchwork`` with
``set_config``/``get_config``, ``clean_points``, ``segment`` and
``filter_ground_points``.  Point clouds are padded to power-of-two
capacities (``api.py:31-35``), so scans of any size reuse a few shapes.
Under the default ``segment_impl="fused"``, capacities above the fit gate
(``fit_cuda.megakernel_fits``: any cloud of 131,073 points or more, whose
bucket is 262,144) take the generic level engine, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.config import PatchworkConfig
from .core.types import GroundResult
from .segment.engine import filter_ground

__all__ = ["RecursivePatchwork"]


def _bucket_capacity(n: int, min_cap: int = 1024) -> int:
    cap = min_cap
    while cap < n:
        cap *= 2
    return cap


class RecursivePatchwork:
    """Drop-in style replacement for the reference RecursivePatchwork class,
    running on an explicit ``device`` (a CUDA device runs the kernels)."""

    def __init__(self, config: PatchworkConfig | None = None,
                 device: torch.device | str = "cpu"):
        self.config = config or PatchworkConfig()
        self.device = torch.device(device)

    # -- config (hpp:66-67) --
    def set_config(self, config: PatchworkConfig) -> None:
        self.config = config

    def get_config(self) -> PatchworkConfig:
        return self.config

    # -- static utilities (hpp:56-64) --
    @staticmethod
    def clean_points(points: np.ndarray) -> np.ndarray:
        """Drop NaN/inf rows (cpp:19-35)."""
        points = np.asarray(points, np.float32)
        return points[np.isfinite(points).all(axis=1)]

    def _pad(self, points: np.ndarray):
        points = np.asarray(points, np.float32)[:, :3]
        n = len(points)
        cap = _bucket_capacity(n)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = points
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return (torch.from_numpy(xyz).to(self.device),
                torch.from_numpy(valid).to(self.device), n)

    def segment(self, points: np.ndarray) -> Tuple[GroundResult, int]:
        """Run the engine; returns the mask bundle plus true point count."""
        xyz, valid, n = self._pad(points)
        return filter_ground(xyz, valid, self.config), n

    def filter_ground_points(
        self, points: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ground_points, non_ground_points) — reference cpp:310-426.

        Non-ground includes finite points beyond the filtering radius;
        NaN/inf points are dropped entirely.
        """
        res, n = self.segment(points)
        pts = np.asarray(points, np.float32)[:, :3]
        g = res.ground[:n].cpu().numpy()
        v = res.valid[:n].cpu().numpy()
        return pts[g & v], pts[v & ~g]
