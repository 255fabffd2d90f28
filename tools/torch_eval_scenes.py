#!/usr/bin/env python3
"""Per-scene segmentation accuracy of the PyTorch port on the hard labeled
synthetic scenes (``io.synthetic.HARD_SCENES``: slope, curb and ramp,
overhang, sparse far field, rolling valley), exact and fast mode.

The counterpart of tools/eval_scenes.py: the same scenes, seeds, metrics
(IoU, F1, precision and recall of the ground mask against the labels made
by construction, averaged over the seeds, rounded to 4 decimals) and JSON
record, on ``patchwork_tpu_torch`` only.  Each scene's seeds go through
``filter_ground_batched`` as one batch, on the card unless ``--device cpu``.
chip_smoke.py phase 5 calls :func:`run` and holds every IoU within 0.001 of
EVAL_r05.json, the JAX package's record at the default size.

Usage:
  python3 tools/torch_eval_scenes.py [--points 65536] [--seeds 2]
      [--json-out eval.json] [--device cpu]

Prints one JSON line; per-scene detail in "scenes".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _log_stderr(msg):
    print(msg, file=sys.stderr)


def run(points: int = 65536, seeds: int = 2, device=None, log=_log_stderr):
    """The record of one evaluation (tools/eval_scenes.run's keys, plus
    ``device``)."""
    import torch
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.core.device import resolve_device
    from patchwork_tpu_torch.io.synthetic import HARD_SCENES, hard_labeled_scene
    from patchwork_tpu_torch.utils.metrics import mask_metrics

    dev = resolve_device(device)
    cfgs = {
        "exact": PatchworkConfig(),
        "fast": PatchworkConfig(fast_covariance=True),
    }
    scenes = {}
    for name in HARD_SCENES:
        made = [hard_labeled_scene(name, points, seed=s) for s in range(seeds)]
        xyz = torch.from_numpy(np.stack([m[0] for m in made])).to(dev)
        valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        per_cfg = {}
        for cfg_name, cfg in cfgs.items():
            ground = filter_ground_batched(xyz, valid, cfg).ground.cpu().numpy()
            ms = [mask_metrics(g, labels) for g, (_, labels) in zip(ground, made)]
            per_cfg[cfg_name] = {
                key: round(float(np.mean([m[key] for m in ms])), 4)
                for key in ("iou", "f1", "precision", "recall")}
        scenes[name] = per_cfg
        log(f"# {name}: exact IoU {per_cfg['exact']['iou']:.4f} "
            f"fast IoU {per_cfg['fast']['iou']:.4f}")

    mean_iou = float(np.mean([s["exact"]["iou"] for s in scenes.values()]))
    return {
        "metric": "hard_scene_mean_iou",
        "value": round(mean_iou, 4),
        "unit": "IoU",
        "points": points,
        "seeds": seeds,
        "device": str(dev),
        "scenes": scenes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.points, args.seeds, args.device)
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
