#!/usr/bin/env python3
"""KITTI(-360) sequence evaluation with the PyTorch port: throughput, and
ground-mask metrics when labels are given.

The counterpart of tools/eval_kitti.py: a directory of velodyne ``.bin``
scans streams through ``node.PatchworkNode`` (on the card unless
``--device cpu``), reporting scans/s and the node's stage times; with a
labels directory (per-point semantic labels, one ``.label`` / ``.bin``
uint32 file per scan, SemanticKITTI format: lower 16 bits = semantic class)
it adds the ground-mask IoU, F1, precision and recall against the ground
classes, summed over the sequence.  No KITTI data ships with the repo: the
tests write SemanticKITTI-format fixtures.

Usage:
  python3 tools/torch_eval_kitti.py /data/kitti/velodyne
      [--labels /data/kitti/labels] [--limit N] [--capacity 131072]
      [--config-json cfg.json] [--device cpu]
      [--json-out kitti.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# SemanticKITTI ground-ish classes: road, parking, sidewalk, other-ground,
# lane-marking, terrain
GROUND_LABELS = {40, 44, 48, 49, 60, 72}


def evaluate(velodyne_dir, labels_dir=None, limit=None, capacity=131072,
             config=None, device=None, log=print):
    """Run the sequence; returns a summary dict (tools/eval_kitti.evaluate's
    keys: scans, scans_per_s, and with ``labels_dir`` iou, f1, precision
    and recall over the sequence)."""
    from patchwork_tpu_torch.core.config import PatchworkConfig
    from patchwork_tpu_torch.io.kitti import list_sequence, read_bin
    from patchwork_tpu_torch.node import NodeParams, PatchworkNode
    from patchwork_tpu_torch.utils.metrics import format_metrics, mask_metrics

    cfg = config or PatchworkConfig()
    node = PatchworkNode(NodeParams(), config=cfg, capacity=capacity,
                         device=device)

    paths = list_sequence(velodyne_dir)
    if limit:
        paths = paths[:limit]
    label_paths = None
    if labels_dir:
        label_paths = sorted(
            os.path.join(labels_dir, p) for p in os.listdir(labels_dir)
        )[: len(paths)]

    agg = {"tp": 0.0, "fp": 0.0, "fn": 0.0}
    results = node.run(read_bin(p) for p in paths)
    for r in results:
        if label_paths:
            raw = np.fromfile(label_paths[r.index], dtype=np.uint32) & 0xFFFF
            pts = read_bin(paths[r.index])
            n = min(len(raw), len(pts), capacity)
            truth = np.isin(raw[:n], list(GROUND_LABELS))
            m = mask_metrics(r.ground_mask[:n], truth, r.valid_mask[:n])
            agg["tp"] += m["tp"]
            agg["fp"] += m["fp"]
            agg["fn"] += m["fn"]
            log(f"frame {r.index:4d}: {format_metrics(m)} "
                f"({r.latency_s * 1e3:.1f} ms)")

    log(node.times.report())
    total = sum(r.latency_s for r in results)
    out = {"scans": len(results),
           "scans_per_s": len(results) / max(total, 1e-9),
           "device": str(node.device),
           "stages": node.times.summary()}
    if results:
        log(f"\n{len(results)} scans, {out['scans_per_s']:.1f} scans/s")
    if label_paths and agg["tp"] + agg["fn"] > 0:
        tp, fp, fn = agg["tp"], agg["fp"], agg["fn"]
        out["iou"] = tp / max(tp + fp + fn, 1.0)
        out["precision"] = tp / max(tp + fp, 1.0)
        out["recall"] = tp / max(tp + fn, 1.0)
        out["f1"] = 2 * tp / max(2 * tp + fp + fn, 1.0)
        log(f"sequence ground IoU: {out['iou']:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("velodyne", help="directory of .bin scans")
    ap.add_argument("--labels", help="directory of per-scan label files")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--config-json", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from patchwork_tpu_torch.core.config import PatchworkConfig

    cfg = PatchworkConfig()
    if args.config_json:
        with open(args.config_json) as f:
            cfg = PatchworkConfig.from_json(f.read())
    out = evaluate(args.velodyne, args.labels, args.limit, args.capacity, cfg,
                   args.device)
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
