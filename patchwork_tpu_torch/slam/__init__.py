"""SLAM back end on the card: ground-constrained odometry, keyframe pose
graph, Schur-complement bundle adjustment (on one device or sharded over a
mesh), world-frame map.

Counterpart of ``patchwork_tpu/slam``."""

from .se3 import (se3_apply, se3_compose, se3_exp, se3_identity, se3_inverse,
                  se3_log, so3_exp, so3_log)
from .scan_matching import MatchResult, icp_ground_constrained, nearest_neighbors
from .pose_graph import (PoseGraph, ate_rmse, edge_residuals,
                         optimize_pose_graph, sparsify_pose_graph)
from .odometry import LidarOdometry, OdometryConfig
from .ba import (BAProblem, ba_residuals, bundle_adjust,
                 bundle_adjust_sharded)
from .landmarks import build_ba_problem, extract_observations, refine_with_ba
from .mapping import build_map, save_map_npz, save_map_ply

__all__ = ["se3_apply", "se3_compose", "se3_exp", "se3_identity",
           "se3_inverse", "se3_log", "so3_exp", "so3_log", "MatchResult",
           "icp_ground_constrained", "nearest_neighbors", "PoseGraph",
           "ate_rmse", "edge_residuals", "optimize_pose_graph",
           "sparsify_pose_graph", "LidarOdometry", "OdometryConfig",
           "BAProblem", "ba_residuals", "bundle_adjust",
           "bundle_adjust_sharded", "build_ba_problem",
           "extract_observations", "refine_with_ba", "build_map",
           "save_map_npz", "save_map_ply"]
