"""Deployment descriptor: one operator-editable file -> a configured run.

Counterpart of ``patchwork_tpu/launch.py``; :func:`run_launch` takes the
``device`` to run on.  JSON needs nothing beyond the standard library; a
``.yaml``/``.yml`` descriptor imports PyYAML when it is read.

The middleware-free analogue of the reference's launch file
(launch/recursive_patchwork.launch.py:11-73): where ROS2 launch maps 8
DeclareLaunchArguments onto node parameters and topic remappings, this
maps ONE YAML/JSON document onto the full deployment surface — the node
parameter block (NodeParams, the same 8 reference parameters), algorithm
config overrides (PatchworkConfig fields), the input source (KITTI
directory / DB3/MCAP bag / synthetic demo), and runtime capacity — and
runs the streaming node over it.

Example descriptor (YAML; JSON works identically):

    node:
      input_topic: /lidar/points      # bag topic to subscribe
      min_points: 100
      max_iterations: 50
      distance_threshold: 0.1
      angle_threshold: 0.1
    config:                           # PatchworkConfig overrides
      filtering_radius: 80.0
      max_levels: 4
    source:
      kitti: /data/kitti/velodyne     # or  bag: /data/run1.mcap
      limit: 100                      # optional frame cap
    capacity: 131072
    out_prefix: run1

CLI: ``patchwork-tpu-torch --launch config.json`` (cli.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .core.config import PatchworkConfig
from .node import NodeParams, PatchworkNode

__all__ = ["LaunchDescription", "load_launch", "run_launch"]


@dataclasses.dataclass(frozen=True)
class LaunchDescription:
    """Parsed deployment descriptor (one file = one configured run)."""

    node: NodeParams
    config: PatchworkConfig
    source: Dict[str, Any]
    capacity: int = 131072
    out_prefix: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "node": dataclasses.asdict(self.node),
            "config": json.loads(self.config.to_json()),
            "source": dict(self.source),
            "capacity": self.capacity,
            "out_prefix": self.out_prefix,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LaunchDescription":
        known_node = {f.name for f in dataclasses.fields(NodeParams)}
        node_kw = dict(d.get("node") or {})
        unknown = set(node_kw) - known_node
        if unknown:
            raise ValueError(f"unknown node parameters: {sorted(unknown)}")
        cfg_kw = dict(d.get("config") or {})
        source = dict(d.get("source") or {})
        src_keys = {"kitti", "bag", "demo"} & set(source)
        if len(src_keys) != 1:
            raise ValueError(
                "source needs exactly one of kitti:/bag:/demo:, got "
                f"{sorted(source)}")
        return cls(
            node=NodeParams(**node_kw),
            config=PatchworkConfig(**cfg_kw),
            source=source,
            capacity=int(d.get("capacity", 131072)),
            out_prefix=d.get("out_prefix"),
        )


def load_launch(path: str) -> LaunchDescription:
    """Parse a YAML or JSON descriptor file (by extension: ``.json`` is
    JSON, anything else YAML)."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        doc = json.loads(text)
    else:
        import yaml

        doc = yaml.safe_load(text)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: descriptor must be a mapping")
    return LaunchDescription.from_dict(doc)


def _scans(desc: LaunchDescription) -> Iterator[np.ndarray]:
    src = desc.source
    if "kitti" in src:
        from .io.kitti import iter_sequence

        it = iter_sequence(src["kitti"])
    elif "bag" in src:
        from .io.bag import BagReader

        bag = BagReader(src["bag"])
        topic = src.get("topic") or desc.node.input_topic
        if topic not in bag.topic_names():
            pc = bag.point_cloud_topics()
            if not pc:
                raise ValueError(f"no point-cloud topics in {src['bag']}")
            topic = pc[0]
        it = bag.iter_point_clouds(topic)
    else:
        from .io.synthetic import demo_point_cloud

        demo = src["demo"] or {}
        n_frames = int(demo.get("frames", 8))
        n_pts = int(demo.get("points", 10000))
        it = (demo_point_cloud(n_pts, seed=i) for i in range(n_frames))
    limit = src.get("limit")
    for i, scan in enumerate(it):
        if limit is not None and i >= int(limit):
            return
        yield scan


def run_launch(desc: LaunchDescription, log=print,
               device: torch.device | str = "cpu"):
    """Execute the descriptor: stream every frame through the node on
    ``device``.

    Returns (results, node).  Writes packed masks when out_prefix is set.
    """
    node = PatchworkNode(desc.node, config=desc.config,
                         capacity=desc.capacity, device=device)
    results = node.run(_scans(desc))
    for r in results:
        log(f"Processed frame {r.index} in {r.latency_s*1e3:.1f} ms: "
            f"{r.num_ground} ground, {r.num_obstacles} obstacles")
    log(node.times.report())
    if results and desc.out_prefix:
        from .utils.checkpoint import save_masks

        out = desc.out_prefix + "_masks.npz"
        save_masks(
            out,
            np.stack([r.ground_mask for r in results]),
            np.stack([r.valid_mask for r in results]),
            np.array([r.index for r in results]),
        )
        log(f"Saved: {out}")
    return results, node
