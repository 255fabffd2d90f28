"""Streaming segmentation node — the middleware-free stand-in for the
reference's ROS2 node (src/recursive_patchwork_node.cpp).

Counterpart of ``patchwork_tpu/node.py``, on the card unless ``device="cpu"``
is given.  Scans
come from any iterator (KITTI directory, decoded bag arrays, synthetic
generator), are padded to the caller's fixed capacity and go through
:func:`filter_ground_batched`: one scan at a time with up to
``pipeline_depth`` scans in flight, or ``batch_size`` scans per call.  Sinks
receive fixed-shape masks and counts.

The parameter block mirrors the node's 8 declared parameters
(cpp:16-33), including its mapping of ``angle_threshold`` onto th_seeds
(cpp:40 — a seed *height* margin, not an angle; SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .core.config import PatchworkConfig
from .core.device import resolve_device
from .core.timing import StageTimes
from .segment.engine import filter_ground_batched

__all__ = ["NodeParams", "FrameResult", "PatchworkNode", "run_stream"]


@dataclasses.dataclass
class NodeParams:
    """The reference node's parameter block (cpp:16-33)."""

    input_topic: str = "/lidar/points"
    ground_topic: str = "/patchwork/ground"
    obstacles_topic: str = "/patchwork/obstacles"
    visualization_topic: str = "/patchwork/visualization"
    min_points: int = 100
    max_iterations: int = 50
    distance_threshold: float = 0.1
    # NOTE: feeds th_seeds (seed height margin) for parity with the
    # reference's mapping (cpp:40); the name is historical.
    angle_threshold: float = 0.1

    def to_config(self, base: Optional[PatchworkConfig] = None) -> PatchworkConfig:
        base = base or PatchworkConfig()
        return base.replace(
            max_iter=self.max_iterations,
            th_dist=self.distance_threshold,
            th_seeds=self.angle_threshold,
        )


@dataclasses.dataclass
class FrameResult:
    """Per-frame output bundle (the node's two clouds + marker counts)."""

    index: int
    ground_mask: np.ndarray     # over input rows
    valid_mask: np.ndarray
    num_ground: int
    num_obstacles: int
    latency_s: float

    def ground_points(self, pts: np.ndarray) -> np.ndarray:
        return pts[self.ground_mask[: len(pts)]]

    def obstacle_points(self, pts: np.ndarray) -> np.ndarray:
        m = self.valid_mask[: len(pts)] & ~self.ground_mask[: len(pts)]
        return pts[m]


class PatchworkNode:
    """Streaming engine over fixed-capacity scans on ``device`` (the card
    when none is given; ``"cpu"`` runs the plain versions).

    ``batch_size`` > 1 groups frames into one batched engine call (the
    throughput mode for offline sequences); 1 minimizes per-frame latency.
    Stage times: "h2d" (pad and copy in), "engine" (the engine call, which
    synchronises on its convergence flags), "d2h" (masks and counts out,
    waiting for the last kernels), and "frame" per result.
    """

    def __init__(
        self,
        params: NodeParams | None = None,
        config: PatchworkConfig | None = None,
        capacity: int = 131072,
        batch_size: int = 1,
        device: torch.device | str | None = None,
    ):
        self.params = params or NodeParams()
        self.config = self.params.to_config(config)
        self.capacity = capacity
        self.batch_size = max(batch_size, 1)
        self.device = resolve_device(device)
        self.times = StageTimes()

    def _pad(self, scans: List[np.ndarray], b: int):
        """(b, capacity, 3) and (b, capacity) tensors on the device; rows
        beyond the capacity are dropped, as in the JAX node, and slots
        beyond the scans stay empty."""
        xyz = np.zeros((b, self.capacity, 3), np.float32)
        valid = np.zeros((b, self.capacity), bool)
        for slot, pts in enumerate(scans):
            n = min(len(pts), self.capacity)
            xyz[slot, :n] = np.asarray(pts, np.float32)[:n, :3]
            valid[slot, :n] = True
        return (torch.from_numpy(xyz).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _step(self, xyz, valid):
        res = filter_ground_batched(xyz, valid, self.config)
        obstacles = res.valid & ~res.ground
        return res.ground, res.valid, res.ground.sum(-1), obstacles.sum(-1)

    def _results(self, items, out, t0, per_frame: bool):
        """FrameResults of the (index, pts) ``items`` from one step's
        device outputs."""
        with self.times.time("d2h"):
            g, v, ng, no = (t.cpu().numpy() for t in out)
        dt = time.perf_counter() - t0
        return [FrameResult(index=idx, ground_mask=g[slot],
                            valid_mask=v[slot], num_ground=int(ng[slot]),
                            num_obstacles=int(no[slot]),
                            latency_s=dt if per_frame else dt / len(items))
                for slot, (idx, _) in enumerate(items)]

    def process(self, pts: np.ndarray, index: int = 0) -> Optional[FrameResult]:
        """Process one scan synchronously; None if below min_points
        (reference drops short clouds, cpp:74-78 via empty-check)."""
        if len(pts) < self.params.min_points:
            return None
        t0 = time.perf_counter()
        with self.times.time("h2d"):
            xyz, valid = self._pad([pts], 1)
        with self.times.time("engine"):
            out = self._step(xyz, valid)
        return self._results([(index, pts)], out, t0, True)[0]

    def run(
        self,
        scans: Iterable[np.ndarray],
        sinks: Optional[List[Callable[[np.ndarray, FrameResult], None]]] = None,
        limit: Optional[int] = None,
        pipeline_depth: int = 2,
    ) -> List[FrameResult]:
        """Stream scans through the engine.

        Single-scan mode keeps up to ``pipeline_depth`` scans enqueued
        before pulling the oldest one's results to the host (the reference
        processes strictly sequentially per DDS message).
        """
        if self.batch_size > 1:
            return self._run_batched(scans, sinks or [], limit)
        sinks = sinks or []
        results: List[FrameResult] = []
        inflight: List[tuple] = []  # (index, pts, device outputs, t0)

        def drain_one():
            idx, pts, out, t0 = inflight.pop(0)
            res = self._results([(idx, pts)], out, t0, True)[0]
            self.times.add("frame", res.latency_s)
            results.append(res)
            for sink in sinks:
                sink(pts, res)

        for i, pts in enumerate(scans):
            if limit is not None and i >= limit:
                break
            if len(pts) < self.params.min_points:
                continue
            try:
                t0 = time.perf_counter()
                with self.times.time("h2d"):
                    xyz, valid = self._pad([pts], 1)
                with self.times.time("engine"):
                    out = self._step(xyz, valid)
                inflight.append((i, pts, out, t0))
                while len(inflight) >= pipeline_depth:
                    drain_one()
            except Exception as e:  # per-frame resilience (reference
                # node catches and logs per callback, cpp:105-107)
                print(f"Error processing frame {i}: {type(e).__name__}: {e}")
        while inflight:
            drain_one()
        return results

    def _run_batched(self, scans, sinks, limit) -> List[FrameResult]:
        """Group frames into batches of ``batch_size`` (a short final batch
        is padded with empty frames that are dropped from the results)."""
        results: List[FrameResult] = []
        buf: List[tuple] = []  # (index, pts)

        def flush():
            if not buf:
                return
            t0 = time.perf_counter()
            with self.times.time("h2d"):
                xyz, valid = self._pad([pts for _, pts in buf],
                                       self.batch_size)
            with self.times.time("engine"):
                out = self._step(xyz, valid)
            for res, (_, pts) in zip(self._results(buf, out, t0, False), buf):
                self.times.add("frame", res.latency_s)
                results.append(res)
                for sink in sinks:
                    sink(pts, res)
            buf.clear()

        for i, pts in enumerate(scans):
            if limit is not None and i >= limit:
                break
            if len(pts) < self.params.min_points:
                continue
            buf.append((i, pts))
            if len(buf) == self.batch_size:
                flush()
        flush()
        return results


def run_stream(
    scans: Iterator[np.ndarray],
    params: NodeParams | None = None,
    config: PatchworkConfig | None = None,
    capacity: int = 131072,
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> List[FrameResult]:
    """Convenience wrapper: stream + log like the node's DEBUG output
    (cpp:96-103: 'Processed in N ms: G ground, O obstacles')."""
    node = PatchworkNode(params, config, capacity, device=device)
    results = node.run(scans)
    if verbose:
        for r in results:
            print(
                f"Processed frame {r.index} in {r.latency_s * 1e3:.1f} ms: "
                f"{r.num_ground} ground, {r.num_obstacles} obstacles"
            )
        print(node.times.report())
    return results
