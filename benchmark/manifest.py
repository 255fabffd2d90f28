"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``mixes/<name>.json``) and has the limits of ``correct`` of its own
(``limits/<cell>.json``); the mix names its scene generator
(``traffic/<scene>.py``); each metric is a reader of its own
(``metrics/<name>.py``, with a ``read(run)`` function).  Adding a cell,
a configuration, a mix or a metric adds files and entries: no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType

__all__ = ["Cell", "Metric", "Manifest", "load_module"]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str                          # "end_to_end" or "per_layer"
    workloads: tuple | None = None     # None: every cell that reports it
    moves: str | None = None           # a per-layer metric's end-to-end one


def load_module(path: pathlib.Path) -> ModuleType:
    """Import the Python file at ``path`` as a module of its own (names may
    hold dots, which an import statement cannot spell)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_file_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """The benchmark at ``root`` (a checkout's root, holding
    ``BENCHMARK.json``); its data files lie under ``root/benchmark``."""

    def __init__(self, root: pathlib.Path | str):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]))
                      for w in self.data["workloads"]}
        self.metrics = [
            Metric(m["name"], m["unit"], kind,
                   tuple(m["workloads"]) if "workloads" in m else None,
                   m.get("moves"))
            for kind in ("end_to_end", "per_layer")
            for m in self.data[kind]]
        self._configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        """The configuration's file, as the manifest's entry names it."""
        return json.loads((self.root / self._configs[name]["file"])
                          .read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "mixes" / f"{name}.json").read_text())

    def scene(self, name: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{name}.py")

    def limits(self, cell: str) -> dict:
        """The limit of each number compared in ``cell``'s runs."""
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py")

    def reported(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` prints: its end-to-end metrics
        with ``trace`` off, its per-layer metrics with it on."""
        e2e = [m for m in self.metrics if m.kind == "end_to_end"
               and (m.workloads is None or cell in m.workloads)]
        if not trace:
            return e2e
        names = {m.name for m in e2e}
        return [m for m in self.metrics if m.kind == "per_layer"
                and (cell in m.workloads if m.workloads is not None
                     else m.moves in names)]
