#!/usr/bin/env python3
"""Median and range of the readings two trees left behind.

    python3 tools/torch_ab_summary.py DIR

DIR holds the ``--json`` files of ``tools/torch_kernel_bench.py --sections
scans,profiles`` (and ``host``), one per process, named
``<turn>_<tree>.json`` (two trees run in turns inside one call on one
card).  Prints, per tree and cell, the
median and the range of scans/s and of the profiled batch's device busy
time, host span and idle share, and of the generic path's host times,
with the number of readings.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import sys


def main() -> int:
    root = sys.argv[1]
    cells: dict = {}
    card = None
    for path in sorted(glob.glob(os.path.join(root, "*_*.json"))):
        tree = os.path.basename(path).split("_", 1)[1][:-len(".json")]
        with open(path) as f:
            data = json.load(f)
        card = data.get("card")
        for cell, rate in data.get("scans_per_s", {}).items():
            cells.setdefault(("scans/s", cell), {}).setdefault(
                tree, []).append(rate)
        for cell, row in data.get("profiles", {}).items():
            for key in ("busy_ms", "span_ms", "idle"):
                cells.setdefault((key, cell), {}).setdefault(
                    tree, []).append(row[key])
        for key, v in data.get("host_generic", {}).items():
            if isinstance(v, float):
                cells.setdefault(("host", key), {}).setdefault(
                    tree, []).append(v)
    print(card)
    for (metric, cell), trees in sorted(cells.items()):
        line = []
        for tree, v in sorted(trees.items()):
            line.append(f"{tree} {statistics.median(v):.4g} "
                        f"({min(v):.4g}-{max(v):.4g}, n={len(v)})")
        print(f"{metric:8s} {cell}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
