"""Configuration for the PyTorch / CUDA Recursive Patchwork engine.

Field for field the same dataclass as ``patchwork_tpu/core/config.py`` (the
JAX reference), so a reference config converts through ``to_json()`` into
an equal config here.  Kept as its own module because importing anything
under ``patchwork_tpu`` pulls in JAX.


One frozen, hashable dataclass carries *every* constant of the algorithm,
including the ones the reference hard-codes outside its config struct
(reference: include/recursive_patchwork.hpp:25-36 for the struct;
src/recursive_patchwork.cpp:127,138,153,203,231-232,344-346 for the
hard-coded constants surfaced here as fields).

The config is frozen and hashable: the engine reads every shape (ring
count, sector count, split levels) from it once per call.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PatchworkConfig:
    """Algorithm configuration.

    Field-for-field superset of the reference ``PatchworkConfig``
    (include/recursive_patchwork.hpp:25-36), plus the constants the
    reference hard-codes in src/recursive_patchwork.cpp.
    """

    # --- reference PatchworkConfig fields (hpp:25-36) ---
    sensor_height: float = 1.2
    max_range: float = 150.0
    num_sectors: int = 10
    max_iter: int = 100
    adaptive_seed_height: bool = True
    th_seeds: float = 0.15
    th_dist: float = 0.2
    th_outlier: float = 0.08  # unused by the reference algorithm; kept for parity
    filtering_radius: float = 150.0
    max_split_depth: int = 1000

    # --- constants hard-coded in the reference, surfaced as fields ---
    num_rings: int = 8            # src/recursive_patchwork.cpp:345
    r_min: float = 1.0            # src/recursive_patchwork.cpp:344
    seed_slope: float = 0.2       # z_th = h + 0.2*rel_dist (cpp:153)
    tau_slope: float = 0.2        # tau = th_dist*(1+0.2*rel_dist) (cpp:203)
    split_residual_slope: float = 1.5   # cpp:231
    split_min_points_base: int = 50     # cpp:232
    split_min_points_slope: int = 10    # cpp:232
    flat_area_m2: float = 25.0    # cpp:127
    flat_dz: float = 0.05         # cpp:138
    flat_min_points: int = 10     # cpp:138
    seed_percentile: float = 0.1  # cpp:158 (non-adaptive seed path)
    min_seed_points: int = 3      # cpp:172-182

    # --- engine knobs (no reference equivalent) ---
    # The reference recurses with unbounded (depth<=1000) data-dependent
    # splits (cpp:109-308).  The engine flattens the recursion into
    # `max_levels` batched levels; splits deeper than this are truncated
    # (the node keeps its converged ground mask).  Splits beyond depth ~5
    # are essentially unreachable because min_patch_size grows as 50+10*d
    # and the residual threshold grows as (1+1.5*d).
    max_levels: int = 6

    # Compact node pool for levels >= 1: split children renumber into this
    # many slots, keeping every level's segment count (and segment-op
    # cost) bounded instead of doubling per level.  0 = auto
    # (2 * num_patches, exactly enough for every base patch to split).
    # If more than max_active_nodes/2 nodes split at one depth, the excess
    # (highest node ids) keep their converged masks — raise this for
    # pathologically fragmented scenes.
    max_active_nodes_cfg: int = 0

    # Segment-op backend, as in the JAX reference: None/"fused" (the level
    # path up to the fit gate), "scatter", "onehot" or "pallas" (the
    # generic engine; "pallas" on the segment-op kernels).
    segment_impl: str | None = None

    # Fast (IoU-parity) covariance mode: points
    # are shifted to their base patch's static polar center and each fit
    # iteration runs as ONE fused sweep accumulating raw second moments
    # (cov = M2 - S S^T/n) instead of the reference's two-pass centered
    # accumulation (src/recursive_patchwork.cpp:86-95).  The shift bounds
    # the f32 cancellation so masks stay IoU~=1 vs the exact path, but
    # bitwise parity with oracle/reference.py is no longer guaranteed —
    # leave False when bit-exact masks are required.
    fast_covariance: bool = False

    def __post_init__(self) -> None:
        if self.num_rings < 1 or self.num_sectors < 1:
            raise ValueError("num_rings and num_sectors must be >= 1")
        if self.max_levels < 1:
            raise ValueError("max_levels must be >= 1")
        if self.r_min <= 0 or self.filtering_radius <= self.r_min:
            raise ValueError("need 0 < r_min < filtering_radius")

    # Number of base (level-0) patches, plus helpers used by the engine.
    @property
    def num_patches(self) -> int:
        return self.num_rings * self.num_sectors

    @property
    def max_active_nodes(self) -> int:
        return self.max_active_nodes_cfg or 2 * self.num_patches

    @property
    def effective_levels(self) -> int:
        """Levels actually executed: depth k exists for k <= max_split_depth."""
        return min(self.max_levels, self.max_split_depth + 1)

    def num_nodes(self, level: int) -> int:
        """Number of tree nodes at a given split level (excl. trash slot)."""
        return self.num_patches * (1 << level)

    # --- (de)serialization ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PatchworkConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "PatchworkConfig":
        return dataclasses.replace(self, **kw)

    # --- algorithm-variant presets (BASELINE.json configs[2]) ---
    @classmethod
    def recursive(cls, **kw) -> "PatchworkConfig":
        """Full Recursive Patchwork (the reference's default behavior)."""
        return cls(**kw)

    @classmethod
    def patchwork(cls, **kw) -> "PatchworkConfig":
        """Plain Patchwork: polar-grid seeded plane fitting, NO recursive
        splits (the algorithm the 'Recursive' variant extends)."""
        kw.setdefault("max_split_depth", 0)
        kw.setdefault("max_levels", 1)
        return cls(**kw)

    @classmethod
    def patchwork_pp(cls, **kw) -> "PatchworkConfig":
        """Patchwork++-style: adaptive seeds + distance-scaled thresholds
        with single-level fitting and a tighter flatness early-out —
        approximated within this engine's parameter space."""
        kw.setdefault("max_split_depth", 0)
        kw.setdefault("max_levels", 1)
        kw.setdefault("adaptive_seed_height", True)
        kw.setdefault("flat_dz", 0.1)
        kw.setdefault("num_sectors", 16)
        return cls(**kw)

    VARIANTS = ("recursive", "patchwork", "patchwork_pp")

    @classmethod
    def variant(cls, name: str, **kw) -> "PatchworkConfig":
        if name not in cls.VARIANTS:
            raise ValueError(f"unknown variant {name!r}; options: {cls.VARIANTS}")
        return getattr(cls, name)(**kw)


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Per-sensor config (reference: include/recursive_patchwork.hpp:39-44)."""

    lidar_id: int
    topic_name: str
    rotation_angle_deg: float = 0.0
    ego_radius: float = 2.5


def default_lidar_configs() -> Tuple[LidarConfig, ...]:
    """Default 3-LiDAR IAC layout (reference: src/lidar_fusion.cpp:20-36)."""
    return (
        LidarConfig(1, "/lidar_front", 0.0, 2.5),
        LidarConfig(2, "/lidar_left", 120.0, 2.5),
        LidarConfig(3, "/lidar_right", -120.0, 2.5),
    )
