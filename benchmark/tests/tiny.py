"""A throwaway root holding the benchmark's files and one added cell per
arrival, at a size the CPU runs in a second, held to the limits of a real
cell of that arrival: a cell added from files alone."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
CAPACITY = 4096


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` holding a copy of ``benchmark/`` and a ``BENCHMARK.json``
    with a ``tiny`` configuration (HDL-64E sweeps of 3000-4000 points)
    and, beside each ``<config>.<scene>.<arrival>`` cell, a
    ``tiny.urban.<arrival>`` cell on the urban mix of that arrival cut to
    a small pool, held to that cell's limits and listed under its metrics;
    the code is not touched, only files and entries are added."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads(
        (REPO / "benchmark/configs/kitti360_hdl64.json").read_text())
    conf.update(name="tiny", capacity=CAPACITY)
    conf["sensor"].update(points_min=3000, points_max=4000)
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["capacity"], "why": "tests"})
    for w in list(bench["workloads"]):
        name = "urban." + w["name"].rsplit(".", 1)[1]
        cell = f"tiny.{name}"
        if any(x["name"] == cell for x in bench["workloads"]):
            continue
        mix = json.loads(
            (REPO / f"benchmark/mixes/{name}.json").read_text())
        mix.update(pool=4, check_frames=3)
        if mix["arrival"] == "closed":
            mix.update(batch_size=2, profile={"from_frame": 4, "frames": 4})
        else:
            mix.update(profile={"from_frame": 2, "frames": 3})
        (tmp / f"benchmark/mixes/{cell}.json").write_text(json.dumps(mix))
        shutil.copy(REPO / f"benchmark/limits/{w['name']}.json",
                    tmp / f"benchmark/limits/{cell}.json")
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": cell, "chips": 1,
                                   "why": "tests"})
        for kind in ("end_to_end", "per_layer"):
            for m in bench[kind]:
                if w["name"] in m.get("workloads", []):
                    m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
