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
import math
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .core import timing
from .core.config import PatchworkConfig
from .core.device import resolve_device
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
    """Per-frame output bundle (the node's two clouds + marker counts).

    ``latency_s``: from the frame's arrival at the node (``run`` pulling it
    from its source, or the call of ``process``) to its own result built
    (its masks and counts on the host), in either mode; never a share of a
    batch."""

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

    ``times`` (``core.timing.StageTimes``) holds the node's spans, each
    with the indices of the frames it served: "h2d" (pad, "h2d.pad", and
    copy in, "h2d.copy"), "engine" (the engine call, with the engine's own
    spans under it: "engine.binning", "engine.level" and its phases, an
    "engine.read" for each wait on the card, and "engine.counts", the
    obstacle mask and the counts), "hold" (single-scan mode: a frame's
    engine call returned until its drain starts: while the next frames
    come in where the source keeps up, next to nothing where it paces the
    node), "d2h" (masks and counts out, waiting for the last kernels) and
    "frame" (a frame's arrival until its result is built; in single-scan
    mode h2d + engine + hold + d2h of that frame, exactly).  "drain.paced"
    is a span of no length for each frame that ``run`` drained before its
    next pull because the source paces the node: its count is the frames
    released early.
    A caller may replace ``times`` between calls or during one: spans go
    to the object in place when they open.
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
        self.times = timing.StageTimes()

    def _pad(self, scans: List[np.ndarray], b: int):
        """(b, capacity, 3) and (b, capacity) tensors on the device; rows
        beyond the capacity are dropped, as in the JAX node, and slots
        beyond the scans stay empty."""
        with timing.span("h2d.pad"):
            xyz = np.zeros((b, self.capacity, 3), np.float32)
            valid = np.zeros((b, self.capacity), bool)
            for slot, pts in enumerate(scans):
                n = min(len(pts), self.capacity)
                xyz[slot, :n] = np.asarray(pts, np.float32)[:n, :3]
                valid[slot, :n] = True
        with timing.span("h2d.copy"):
            return (torch.from_numpy(xyz).to(self.device),
                    torch.from_numpy(valid).to(self.device))

    def _step(self, xyz, valid):
        res = filter_ground_batched(xyz, valid, self.config)
        with timing.span("engine.counts"):
            obstacles = res.valid & ~res.ground
            return (res.ground, res.valid, res.ground.sum(-1),
                    obstacles.sum(-1))

    def _results(self, items, out, start: float):
        """FrameResults of the (index, pts, frame span) ``items`` from one
        step's device outputs: the "d2h" span from ``start``, and each
        frame's span closed where the results are on the host."""
        with self.times.time("d2h", tuple(it[0] for it in items),
                             start) as d2h:
            g, v, ng, no = (t.cpu().numpy() for t in out)
        results = []
        for slot, (idx, _, frame) in enumerate(items):
            frame.close(d2h.end)
            results.append(FrameResult(
                index=idx, ground_mask=g[slot], valid_mask=v[slot],
                num_ground=int(ng[slot]), num_obstacles=int(no[slot]),
                latency_s=frame.seconds))
        return results

    def _enqueue(self, frames, scans, b: int, arrival: float | None = None):
        """Pad ``scans`` to ``b`` slots, copy them in and run the engine:
        the "h2d" span from ``arrival`` (now if None), then "engine";
        returns the device outputs and the engine span."""
        with self.times.time("h2d", frames, arrival) as h2d:
            xyz, valid = self._pad(scans, b)
        with self.times.time("engine", frames, h2d.end) as engine:
            out = self._step(xyz, valid)
        return out, engine

    def process(self, pts: np.ndarray, index: int = 0) -> Optional[FrameResult]:
        """Process one scan synchronously; None if below min_points
        (reference drops short clouds, cpp:74-78 via empty-check)."""
        if len(pts) < self.params.min_points:
            return None
        frame = self.times.open("frame", (index,))
        out, engine = self._enqueue((index,), [pts], 1, frame.start)
        return self._results([(index, pts, frame)], out, engine.end)[0]

    def run(
        self,
        scans: Iterable[np.ndarray],
        sinks: Optional[List[Callable[[np.ndarray, FrameResult], None]]] = None,
        limit: Optional[int] = None,
        pipeline_depth: int = 2,
    ) -> List[FrameResult]:
        """Stream scans through the engine.

        Single-scan mode keeps up to ``pipeline_depth`` scans enqueued
        before pulling the oldest one's results to the host, so that a
        frame's last kernels overlap the next frame's host work.  A frame
        arrives when it is pulled from ``scans``.  Before each pull, if
        the last pull waited longer than the last drain took (the source
        paces the node, as a sensor does), every frame in flight is
        drained first: holding it would only delay its result to the next
        arrival (the reference node publishes inside each message's own
        callback).  The rule reads only the clock, so a source whose pull
        works longer than a drain takes, as a file's read or a bag's
        decode does, is paced too: its frames reach the sink before the
        next read and give up the overlap (the wait for the card's tail,
        a fraction of a millisecond at most).  It guesses the next pull
        from the last one: a frame that a paced source hands over at once
        (one that came late) is held until the next arrival.  A frame's
        "hold" span runs from its engine call's return to its drain, and
        each frame drained early adds a "drain.paced" span.  Sinks run on
        the caller's thread.
        """
        if self.batch_size > 1:
            return self._run_batched(scans, sinks or [], limit)
        sinks = sinks or []
        results: List[FrameResult] = []
        inflight: List[tuple] = []  # (index, pts, frame, outputs, hold)
        drain_s = math.inf          # the last drain's seconds; none yet

        def drain_one(paced: bool = False):
            nonlocal drain_s
            idx, pts, frame, out, hold = inflight.pop(0)
            hold.close()
            if paced:
                self.times.open("drain.paced", (idx,), hold.end).close(
                    hold.end)
            res = self._results([(idx, pts, frame)], out, hold.end)[0]
            drain_s = frame.end - hold.end
            results.append(res)
            for sink in sinks:
                sink(pts, res)

        asked = timing.now()
        for i, pts in enumerate(scans):
            arrival = timing.now()
            if limit is not None and i >= limit:
                break
            try:
                if len(pts) >= self.params.min_points:
                    frame = self.times.open("frame", (i,), arrival)
                    out, engine = self._enqueue((i,), [pts], 1, arrival)
                    hold = self.times.open("hold", (i,), engine.end)
                    inflight.append((i, pts, frame, out, hold))
                    while len(inflight) >= pipeline_depth:
                        drain_one()
                if arrival - asked > drain_s:   # the source paces the node
                    while inflight:
                        drain_one(paced=True)
            except Exception as e:  # per-frame resilience (reference
                # node catches and logs per callback, cpp:105-107)
                print(f"Error processing frame {i}: {type(e).__name__}: {e}")
            asked = timing.now()
        while inflight:
            drain_one()
        return results

    def _run_batched(self, scans, sinks, limit) -> List[FrameResult]:
        """Group frames into batches of ``batch_size`` (a short final batch
        is padded with empty frames that are dropped from the results)."""
        results: List[FrameResult] = []
        buf: List[tuple] = []  # (index, pts, frame)

        def flush():
            if not buf:
                return
            frames = tuple(idx for idx, _, _ in buf)
            out, engine = self._enqueue(frames, [pts for _, pts, _ in buf],
                                       self.batch_size)
            for res, (_, pts, _) in zip(self._results(buf, out, engine.end),
                                        buf):
                results.append(res)
                for sink in sinks:
                    sink(pts, res)
            buf.clear()

        for i, pts in enumerate(scans):
            arrival = timing.now()
            if limit is not None and i >= limit:
                break
            if len(pts) < self.params.min_points:
                continue
            buf.append((i, pts, self.times.open("frame", (i,), arrival)))
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
