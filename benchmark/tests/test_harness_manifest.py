"""BENCHMARK.json against the benchmark's contract, the discovery of every
file by name, and a cell added from files alone, run on the CPU."""

from __future__ import annotations

import json
import re

import pytest
import torch

from benchmark.harness import CHECKS, run_cell
from benchmark.manifest import Manifest

from .tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line_ok(w) for w in BENCH["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line_ok(w["why"])
        assert NAME.match(w["traffic"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_manifest_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line_ok(m["layer"])
        assert m["moves"] in e2e
        # each of its cells reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    bench = Manifest(REPO)
    for cell in cells:
        e2e_here = bench.reported(cell, False)
        assert "setup_s" in [m.name for m in e2e_here] and len(e2e_here) >= 2
        assert bench.reported(cell, True)


def test_every_file_is_found_by_name():
    bench = Manifest(REPO)
    for cell in bench.cells.values():
        conf = bench.config(cell.config)
        assert conf["name"] == cell.config and conf["reduced"] == []
        mix = bench.mix(cell.traffic)
        assert callable(bench.scene(mix["scene"]).scan)
    for cell in bench.cells:
        limits = bench.limits(cell)
        assert set(limits) == set(CHECKS)
        assert limits["frames_failed"] == limits["valid_bits"] == 0
    for m in bench.metrics:
        assert callable(bench.reader(m.name).read)
    with pytest.raises(KeyError):
        bench.cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric")


def test_config_files_state_what_the_node_runs():
    from benchmark.harness import algorithm_values
    import dataclasses
    from patchwork_tpu_torch import PatchworkConfig
    from patchwork_tpu_torch.node import NodeParams

    for c in BENCH["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        node = NodeParams(**conf["node_params"])
        run = dataclasses.asdict(
            node.to_config(PatchworkConfig(**conf["patchwork_config"])))
        assert run == algorithm_values(conf) == conf["patchwork_config"]
        assert conf["source"] == c["source"]
        assert conf["sensor"]["points_max"] <= conf["capacity"]
        assert conf["mode"] == "exact"
        assert not run["fast_covariance"]


@pytest.mark.parametrize("cell", ["tiny.urban.offline", "tiny.urban.live"])
def test_a_cell_added_from_files_alone(tmp_path, cell):
    bench = Manifest(tiny_root(tmp_path))
    for trace in (False, True):
        line = run_cell(bench, cell, 2**31 + 21, 1.0, trace,
                        torch.device("cpu"), 0.0, {"name": "cpu"})
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(line["device"])
        want = {m.name for m in bench.reported(cell, trace)}
        got = set(line["metrics"])
        assert got <= want
        for v in line["metrics"].values():
            assert set(v) == {"value", "unit"}
        if not trace:
            assert got == want
        else:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(set(c) == {"value", "limit"}
                   for c in line["checks"].values())
