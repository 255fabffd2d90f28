"""Ground-constrained LiDAR odometry pipeline.

Counterpart of ``patchwork_tpu/slam/odometry.py``.  Per scan: Patchwork
segmentation (``filter_ground_batched``, the engine's kernels on the card)
-> a fixed-size random sample of each class -> ground-constrained ICP
against the previous keyframe -> an odometry edge of the keyframe pose
graph.  Everything on the device but the small keyframe bookkeeping.

Each scan's sample is drawn from a ``torch.Generator`` seeded with that
scan's own seed, so it does not depend on the scan's place in a chunk; the
generators are not JAX's threefry, so the samples (and trajectories) differ
from the JAX package's, and are compared by ATE.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.config import PatchworkConfig
from ..core.device import resolve_device
from ..ops.sampling import random_subsample_mask
from ..segment.engine import filter_ground_batched
from .pose_graph import (PoseGraph, ate_rmse, optimize_pose_graph,
                         sparsify_pose_graph)
from .scan_matching import icp_ground_constrained

__all__ = ["OdometryConfig", "LidarOdometry"]

_FRAME_KEYS = ("obst", "obst_valid", "ground", "ground_valid")


class _StackedFrames:
    """Keyframe feature dicts backed by (K, ...) stacks, sliced on demand;
    bulk consumers (loop-closure verification, landmark extraction, the map)
    read ``.stacked``.  ``append`` (add_scan after a parallel ingest) goes
    to an overflow list; the stacked fast paths require ``not extra``."""

    def __init__(self, stacked: dict):
        self.stacked = stacked
        self._k = int(stacked["obst"].shape[0])
        self.extra: List[dict] = []

    def __len__(self):
        return self._k + len(self.extra)

    def __getitem__(self, i):
        if i < 0:
            i += len(self)
        if i < self._k:
            return {k: self.stacked[k][i] for k in _FRAME_KEYS}
        return self.extra[i - self._k]

    def append(self, frame: dict):
        self.extra.append(frame)


def stack_frames(frames) -> dict:
    """(K, ...) stacks of every keyframe's features (a parallel ingest's
    own stacks where nothing was appended since)."""
    if isinstance(frames, _StackedFrames) and not frames.extra:
        return frames.stacked
    return {key: torch.stack([frames[i][key] for i in range(len(frames))])
            for key in _FRAME_KEYS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    capacity: int = 65536          # padded points per scan
    obstacle_samples: int = 2048   # ICP obstacle correspondences
    ground_samples: int = 1024     # ground-plane constraint points
    icp_iters: int = 12
    max_corr_dist: float = 2.0
    coarse_factor: float = 8.0   # initial ICP gate = coarse_factor * max_corr_dist
    keyframe_every: int = 1        # keyframe cadence (frames)
    edge_info_trans: float = 100.0  # odometry edge information (1/sigma^2)
    edge_info_rot: float = 400.0


class LidarOdometry:
    """Streaming odometry: feed scans, accumulate a keyframe pose graph.

    Runs on the card unless ``device`` names another (``"cpu"``)."""

    def __init__(self, patchwork: Optional[PatchworkConfig] = None,
                 cfg: Optional[OdometryConfig] = None, device=None):
        self.pw = patchwork or PatchworkConfig()
        self.cfg = cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._frames = []                     # device features per keyframe
        self.poses: List[np.ndarray] = []     # world_T_keyframe
        self.edges: List[tuple] = []          # (i, j, T_ij (4,4) np)

    # -- per-scan features ---------------------------------------------------

    def _extract(self, xyz: torch.Tensor, valid: torch.Tensor, seeds):
        """Segment (B, N, 3) scans and take a fixed-size sample of each
        class: (obst (B, S_o, 3), obst_valid, ground (B, S_g, 3),
        ground_valid).  Unused slots hold point 0 and are invalid."""
        c = self.cfg
        res = filter_ground_batched(xyz, valid, self.pw)
        obst = res.valid & ~res.ground
        sel_o, sel_g = [], []
        for b, seed in enumerate(seeds):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            sel_o.append(random_subsample_mask(obst[b], c.obstacle_samples,
                                               gen))
            sel_g.append(random_subsample_mask(res.ground[b],
                                               c.ground_samples, gen))

        def take(sel, cap):
            # the first `cap` selected indices in order (a stable sort, no
            # host sync), index 0 beyond the count
            idx = torch.sort((~sel).to(torch.uint8), dim=-1,
                             stable=True).indices[:, :cap]
            v = (torch.arange(cap, device=sel.device)[None, :]
                 < sel.sum(-1, keepdim=True))
            idx = torch.where(v, idx, torch.zeros_like(idx))
            return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3)), v

        o, ov = take(torch.stack(sel_o), c.obstacle_samples)
        g, gv = take(torch.stack(sel_g), c.ground_samples)
        return o, ov, g, gv

    def _match(self, src: dict, tgt: dict, init: torch.Tensor):
        c = self.cfg
        return icp_ground_constrained(
            src["obst"], src["obst_valid"], src["ground"],
            src["ground_valid"], tgt["obst"], tgt["obst_valid"],
            tgt["ground"], tgt["ground_valid"], init=init, iters=c.icp_iters,
            max_corr_dist=c.max_corr_dist, coarse_factor=c.coarse_factor)

    def _pad_host(self, pts: np.ndarray, cap: int | None = None):
        cap = self.cfg.capacity if cap is None else cap
        n = min(len(pts), cap)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = np.asarray(pts, np.float32)[:n, :3]
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return xyz, valid

    def _upload(self, xyz: np.ndarray, valid: np.ndarray):
        return (torch.from_numpy(xyz).to(self.device),
                torch.from_numpy(valid).to(self.device))

    # -- ingest --------------------------------------------------------------

    def add_scan(self, pts: np.ndarray, seed: int = 0) -> np.ndarray:
        """Process one scan; returns the current world pose estimate.

        Every scan is matched against the last keyframe; a new keyframe
        (graph node + odometry edge) is made every ``cfg.keyframe_every``
        frames."""
        xyz, valid = self._pad_host(pts)
        o, ov, g, gv = self._extract(*self._upload(xyz[None], valid[None]),
                                     [seed])
        return self._ingest({"obst": o[0], "obst_valid": ov[0],
                             "ground": g[0], "ground_valid": gv[0]})

    def add_scans(self, scans, seeds=None, batch: int = 8,
                  parallel_icp: bool = False,
                  pair_chunk: int = 32) -> np.ndarray:
        """Batched ingest of a scan sequence; returns the (K, 4, 4) poses.

        Segmentation and sampling run in chunks of ``batch`` scans (one
        ``filter_ground_batched`` a chunk).  By default the ICP chain then
        consumes the features in order, with the constant-velocity warm
        start of :meth:`add_scan`.  ``parallel_icp=True`` (keyframe_every
        == 1) matches all consecutive pairs ``pair_chunk`` at a time from
        the identity, then re-matches the pairs whose inlier RMSE is an
        outlier warm-started from their predecessor's delta, keeping the
        lower RMSE."""
        if seeds is None:
            seeds = range(len(scans))
        seeds = list(seeds)
        feats = []
        t0 = time.perf_counter()
        # the padded capacity shrinks to the batch's need, in 4096 steps
        longest = max((len(p) for p in scans), default=0)
        cap = min(self.cfg.capacity, max(4096, -(-longest // 4096) * 4096))
        for s0 in range(0, len(scans), batch):
            chunk = scans[s0:s0 + batch]
            padded = [self._pad_host(p, cap) for p in chunk]
            xyz, valid = self._upload(np.stack([x for x, _ in padded]),
                                      np.stack([v for _, v in padded]))
            o, ov, g, gv = self._extract(xyz, valid,
                                         seeds[s0:s0 + len(chunk)])
            if parallel_icp:
                feats.append((o, ov, g, gv))
            else:
                for i in range(len(chunk)):
                    self._ingest({"obst": o[i], "obst_valid": ov[i],
                                  "ground": g[i], "ground_valid": gv[i]})
        _sync(self.device)
        key = "extract_s" if parallel_icp and feats else "extract_and_icp_s"
        self.last_timings = {key: round(time.perf_counter() - t0, 2)}
        t0 = time.perf_counter()
        if parallel_icp:
            if self.cfg.keyframe_every != 1:
                raise ValueError("parallel_icp requires keyframe_every == 1")
            if len(self._frames):
                raise ValueError(
                    "parallel_icp rebuilds the whole trajectory; call it on "
                    "a fresh LidarOdometry (no scans ingested yet)")
            if feats:
                self._ingest_parallel(
                    {k: torch.cat([f[i] for f in feats])
                     for i, k in enumerate(_FRAME_KEYS)}, pair_chunk)
        self.last_timings["icp_s"] = round(time.perf_counter() - t0, 2)
        return np.stack(self.poses)

    def _solve_pairs(self, stacked: dict, pair_idx: np.ndarray,
                     inits: np.ndarray, pair_chunk: int):
        """ICP of pairs (i + 1 -> i), ``pair_chunk`` pairs a batch; one
        copy to the host at the end."""
        Ts, rmses = [], []
        for s0 in range(0, len(pair_idx), pair_chunk):
            tgt = torch.from_numpy(pair_idx[s0:s0 + pair_chunk]).to(
                self.device)
            src = tgt + 1
            init = torch.from_numpy(np.ascontiguousarray(
                inits[s0:s0 + pair_chunk], np.float32)).to(self.device)
            res = self._match({k: v[src] for k, v in stacked.items()},
                              {k: v[tgt] for k, v in stacked.items()}, init)
            Ts.append(res.transform)
            rmses.append(res.rmse)
        return (torch.cat(Ts).cpu().numpy(), torch.cat(rmses).cpu().numpy())

    def _ingest_parallel(self, stacked: dict, pair_chunk: int) -> None:
        """Parallel ICP chain: a full pass from identity, selective retry."""
        k = int(stacked["obst"].shape[0])
        eye = np.eye(4, dtype=np.float32)
        if k > 1:
            all_pairs = np.arange(k - 1)
            T1, r1 = self._solve_pairs(
                stacked, all_pairs, np.broadcast_to(eye, (k - 1, 4, 4)),
                pair_chunk)
            # identity inits converge except on sharp motion, which shows as
            # an outlier inlier RMSE: re-match those pairs from their
            # predecessor's pass-1 delta, keep whichever scores lower
            med = float(np.median(r1))
            bad = np.where(r1 > max(2.0 * med, 0.05))[0]
            T = T1.copy()
            if len(bad):
                inits2 = np.where((bad > 0)[:, None, None],
                                  T1[np.maximum(bad - 1, 0)], eye[None])
                T2, r2 = self._solve_pairs(stacked, bad, inits2, pair_chunk)
                better = r2 < r1[bad]
                T[bad[better]] = T2[better]
            T = T.astype(np.float32)
        else:
            T = np.zeros((0, 4, 4), np.float32)
        self._frames = _StackedFrames(stacked)
        self.poses = [eye.copy()]
        self.edges = []
        for i in range(k - 1):
            self.poses.append((self.poses[-1] @ T[i]).astype(np.float32))
            self.edges.append((i, i + 1, T[i]))
        self._frame_counter = k - 1
        self.current_pose = self.poses[-1]
        self._last_delta = T[-1] if k > 1 else eye.copy()

    def _ingest(self, frame: dict) -> np.ndarray:
        if not len(self._frames):
            self._frames.append(frame)
            self.poses.append(np.eye(4, dtype=np.float32))
            self._frame_counter = 0
            self.current_pose = self.poses[-1]
            self._last_delta = np.eye(4, dtype=np.float32)
            return self.poses[-1]
        prev = self._frames[-1]
        # constant-velocity warm start: predict this frame's pose from the
        # last inter-frame motion, relative to the keyframe
        predicted = self.current_pose @ self._last_delta
        init = torch.from_numpy(
            (np.linalg.inv(self.poses[-1]) @ predicted).astype(np.float32)
        ).to(self.device)
        T_key_cur = self._match(frame, prev, init).transform.cpu().numpy()
        pose = (self.poses[-1] @ T_key_cur).astype(np.float32)
        self._last_delta = (np.linalg.inv(self.current_pose) @ pose
                            ).astype(np.float32)
        self.current_pose = pose
        self._frame_counter += 1
        if self._frame_counter % self.cfg.keyframe_every == 0:
            self._frames.append(frame)
            self.poses.append(pose)
            self.edges.append((len(self.poses) - 2, len(self.poses) - 1,
                               T_key_cur))
        return pose

    # -- loop closures and the graph ---------------------------------------

    def add_loop_closure(self, i: int, j: int, seed: int = 0) -> np.ndarray:
        """Match keyframe j against keyframe i and add a closure edge."""
        init = torch.from_numpy(
            (np.linalg.inv(self.poses[i]) @ self.poses[j]).astype(np.float32)
        ).to(self.device)
        T_ij = self._match(self._frames[j], self._frames[i],
                           init).transform.cpu().numpy()
        self.edges.append((i, j, T_ij))
        return T_ij

    def detect_loop_closures(
        self,
        radius: float = 5.0,
        min_separation: int = 4,
        max_rmse: float = 0.5,
        min_inliers: int = 200,
        max_candidates: int | None = 10,
        pair_chunk: int = 32,
    ) -> List[tuple]:
        """Find and verify loop closures.

        Candidates: keyframe pairs whose estimated positions lie within
        ``radius`` and at least ``min_separation`` keyframes apart.
        ``max_candidates=None`` sizes the budget at ~K/3 (at least 10),
        spent spread along the trajectory (the nearest candidate per bucket
        of the later keyframe, the rest by distance).  Candidates are
        ICP-matched ``pair_chunk`` at a time; an edge is added where the
        match clears the inlier and RMSE gates.  Returns the accepted
        (i, j) pairs.
        """
        if len(self.poses) < min_separation + 2:
            return []
        pos = np.stack(self.poses)[:, :3, 3]
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        k = len(pos)
        if max_candidates is None:
            max_candidates = max(10, k // 3)
        ii, jj = np.triu_indices(k, k=min_separation)
        near = d[ii, jj] < radius
        ii, jj, dd = ii[near], jj[near], d[ii, jj][near]
        existing = {(a, b) for a, b, _ in self.edges}
        fresh = np.array([(int(a), int(b)) not in existing
                          for a, b in zip(ii, jj)], bool)
        ii, jj, dd = ii[fresh], jj[fresh], dd[fresh]
        if len(ii) == 0:
            return []
        spacing = max(1, -(-k // max_candidates))
        order = np.argsort(dd, kind="stable")
        picked, picked_set, seen_bins = [], set(), set()
        for t in order:
            b = int(jj[t]) // spacing
            if b not in seen_bins:
                seen_bins.add(b)
                picked.append(t)
                picked_set.add(int(t))
        for t in order:  # fill any remaining budget by distance
            if len(picked) >= max_candidates:
                break
            if int(t) not in picked_set:
                picked.append(t)
                picked_set.add(int(t))
        picked = np.asarray(picked[:max_candidates])
        cand = [(int(ii[t]), int(jj[t])) for t in picked]

        m = len(cand)
        inits = np.stack([
            (np.linalg.inv(self.poses[i]) @ self.poses[j]).astype(np.float32)
            for i, j in cand])
        stacked = stack_frames(self._frames)
        Ts, rmses, inliers = [], [], []
        for s0 in range(0, m, pair_chunk):
            part = cand[s0:s0 + pair_chunk]
            src = torch.tensor([j for _, j in part], device=self.device)
            tgt = torch.tensor([i for i, _ in part], device=self.device)
            res = self._match(
                {key: v[src] for key, v in stacked.items()},
                {key: v[tgt] for key, v in stacked.items()},
                torch.from_numpy(inits[s0:s0 + pair_chunk]).to(self.device))
            Ts.append(res.transform)
            rmses.append(res.rmse)
            inliers.append(res.num_inliers)
        Ts = torch.cat(Ts).cpu().numpy()
        rmses = torch.cat(rmses).cpu().numpy()
        inliers = torch.cat(inliers).cpu().numpy()
        accepted = []
        for t, (i, j) in enumerate(cand):
            if inliers[t] >= min_inliers and rmses[t] <= max_rmse:
                self.edges.append((i, j, Ts[t]))
                accepted.append((i, j))
        return accepted

    def build_graph(self) -> PoseGraph:
        c = self.cfg
        e = max(len(self.edges), 1)
        info = np.zeros((e, 6, 6), np.float32)
        info[:, :3, :3] = np.eye(3) * c.edge_info_trans
        info[:, 3:, 3:] = np.eye(3) * c.edge_info_rot
        ei = np.array([x[0] for x in self.edges] or [0], np.int32)
        ej = np.array([x[1] for x in self.edges] or [0], np.int32)
        eT = np.stack([x[2] for x in self.edges]
                      or [np.eye(4, dtype=np.float32)])
        return PoseGraph.from_numpy(np.stack(self.poses), ei, ej, eT, info,
                                    device=self.device)

    def optimize(self, iters: int = 10, solver: str | None = None,
                 max_degree: int | None = None) -> np.ndarray:
        """Optimize the pose graph; updates and returns all poses.

        ``max_degree``: prune loop edges first (:func:`sparsify_pose_graph`).
        """
        g = self.build_graph()
        if max_degree is not None:
            g = sparsify_pose_graph(g, max_degree=max_degree)
        poses = optimize_pose_graph(g, iters=iters,
                                    solver=solver).poses.cpu().numpy()
        self.poses = [p for p in poses]
        return poses

    def trajectory_error(self, gt_poses: np.ndarray) -> float:
        poses = torch.from_numpy(np.stack(self.poses)).to(self.device)
        gt = torch.from_numpy(np.asarray(gt_poses, np.float32)).to(self.device)
        return float(ate_rmse(poses, gt))
