"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

The system under test is ``patchwork_tpu_torch.node.PatchworkNode.run``
(host scans in, masks and counts on the host out), the served path of the
reference's ROS2 node.  From the program the harness takes only that
node, its stage times (``node.times``) and its launch counter
(``kernels.fit_cuda.LAUNCHES``); everything it holds the node to is its
own: the scans (``traffic/``), the reference (``reference/``), the
arithmetic (``arith.py``) and the trace's reduction (``devtrace.py``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import reference, traffic
from .devtrace import DeviceTrace, TraceSummary, short_name
from .manifest import Manifest

__all__ = ["RunRecord", "Sink", "algorithm_values", "run_cell",
           "compare", "CHECKS"]

# The reference node's mapping of its declared parameters onto the
# algorithm's (src/recursive_patchwork_node.cpp:38-40).
NODE_TO_ALGORITHM = {"max_iterations": "max_iter",
                     "distance_threshold": "th_dist",
                     "angle_threshold": "th_seeds"}

# The numbers compared, in the order printed; each cell's limits are
# ``limits/<cell>.json``.
CHECKS = ("frames_failed", "valid_bits", "label_ppm", "patch_ppm",
          "count_ppm")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunRecord:
    """What a run saw, for the metric readers (``metrics/<name>.py``).
    Times are ``time.perf_counter()`` seconds."""

    arrival: str                      # "closed" or "open"
    t0: float                         # the first timed scan
    t_end: float                      # the window's end
    setup_s: float
    handed: List[float]               # per frame: handed to the node
    due: Optional[List[float]]        # per frame, open loop: due time
    arrived: Dict[int, float]         # per frame: its result at the sink
    stages: Dict[str, dict]           # node.times.summary() of the window
    engine_calls: int
    launches: Dict[str, int]          # kernel C calls during the window
    trace: Optional[TraceSummary]     # the profiled stretch
    traced_calls: int                 # engine calls inside it
    work: Optional[reference.FitWork]  # the algorithm's fit work in it
    card: Dict[str, str]              # name, power_limit


class Sink:
    """The node's sink: stamps each result's arrival, keeps its counts,
    and keeps the masks of ``keep`` frames drawn from ``seed`` (reservoir
    sampling over the frames in the order they arrive).  It keeps the
    result's own arrays, which the node hands to its user and never
    writes again: no copy inside the window."""

    def __init__(self, keep: int, seed: int,
                 on_result: Optional[Callable[[int], None]] = None):
        self.arrived: Dict[int, float] = {}
        self.counts: Dict[int, tuple] = {}
        self.kept: Dict[int, tuple] = {}
        self._slots: List[int] = []
        self._keep = keep
        self._rng = np.random.default_rng([seed, 3])
        self._seen = 0
        self.on_result = on_result

    def __call__(self, pts, res) -> None:
        self.arrived[res.index] = time.perf_counter()
        self.counts[res.index] = (res.num_ground, res.num_obstacles)
        if len(self._slots) < self._keep:
            self._slots.append(res.index)
            self.kept[res.index] = (res.ground_mask, res.valid_mask)
        else:
            j = int(self._rng.integers(0, self._seen + 1))
            if j < self._keep:
                del self.kept[self._slots[j]]
                self._slots[j] = res.index
                self.kept[res.index] = (res.ground_mask, res.valid_mask)
        self._seen += 1
        if self.on_result is not None:
            self.on_result(res.index)


def algorithm_values(conf: dict) -> dict:
    """The algorithm's parameters as the configuration file states them:
    its ``patchwork_config`` with the node's parameters mapped in."""
    vals = dict(conf["patchwork_config"])
    for param, field in NODE_TO_ALGORITHM.items():
        vals[field] = conf["node_params"][param]
    return vals


def _spanned(fn, name: str):
    def call(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(pool: List[np.ndarray], sink: Sink, frames: int,
            alg: reference.Algorithm, capacity: int,
            work_of: Optional[Dict[int, int]] = None):
    """Hold the node's results to the reference, run on each pool scan
    that a frame used.  Returns (checks, work):

    - ``frames_failed``: frames of the ``frames`` attempted with no result;
    - ``valid_bits``: differing valid bits of the kept frames over the
      node's capacity (rows past a scan's points are invalid), exact:
      validity involves no arithmetic;
    - ``label_ppm``: ground labels of the kept frames that differ from
      the reference's, per million of the points the reference labels
      (those in a patch; a non-return is in none);
    - ``patch_ppm``: the kept frames' patches (a ring and sector of the
      reference's grid) holding a label that differs, per million of
      their patches that hold points; the rows in no patch count as one
      more patch when one of them differs.  Rounding moves the labels of
      a few patches whose fit has two nearby fixed points; an error spread
      thin moves most patches;
    - ``count_ppm``: over every frame with a result, the gaps of its
      ground and obstacle counts to the reference's, summed, per million
      of the points the reference labels in those frames.

    ``work_of`` (pool index -> frames): the reference also counts the fit
    work of those scans, that many times each."""
    p = len(pool)
    used = sorted({i % p for i in sink.counts} | set(work_of or {}))
    ref, work = {}, (reference.FitWork() if work_of else None)
    for k in used:
        w = reference.FitWork() if work_of and k in work_of else None
        g, v, _, patch = reference.filter_ground(pool[k], alg, w)
        ids = reference.patch_ids(pool[k], alg)
        ref[k] = (g, v, int(g.sum()), int((v & ~g).sum()),
                  int(patch.sum()), ids, len(np.unique(ids[ids >= 0])))
        if w is not None:
            for f in dataclasses.fields(w):
                setattr(work, f.name, getattr(work, f.name)
                        + work_of[k] * getattr(w, f.name))
    valid_bits, label_bits, points, patch_bits, patches = 0, 0, 0, 0, 0
    for i, (g, v) in sink.kept.items():
        rg, rv, _, _, labelled, ids, held = ref[i % p]
        n = len(rg)
        differ = g[:n] != rg
        patch_bits += len(np.unique(ids[differ & (ids >= 0)])) + int(
            bool(np.any(differ & (ids < 0)) or np.any(g[n:capacity])))
        patches += held
        valid_bits += int(np.count_nonzero(v[:n] != rv)
                          + np.count_nonzero(v[n:capacity]))
        label_bits += int(np.count_nonzero((g[:n] != rg) & rv)
                          + np.count_nonzero(g[:n] & ~rv)
                          + np.count_nonzero(g[n:capacity]))
        points += labelled
    gaps = {i: abs(c[0] - ref[i % p][2]) + abs(c[1] - ref[i % p][3])
            for i, c in sink.counts.items()}
    counted = sum(ref[i % p][4] for i in gaps)
    bad = {i % p: gap for i, gap in gaps.items() if gap}
    log(f"exact comparison: {label_bits} differing ground labels in "
        f"{patch_bits} of {patches} patches of {len(sink.kept)} kept frames; "
        f"count gaps by pool scan {bad}")
    failed = sum(1 for i in range(frames) if i not in sink.arrived)
    return {"frames_failed": failed, "valid_bits": valid_bits,
            "label_ppm": 1e6 * label_bits / max(points, 1),
            "patch_ppm": 1e6 * patch_bits / max(patches, 1),
            "count_ppm": 1e6 * sum(gaps.values()) / max(counted, 1)}, work


def run_cell(bench: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             card: Dict[str, str]) -> dict:
    """One run of ``workload``; returns the result line (a dict).

    ``t_start``: the process's start on the ``time.perf_counter()`` clock;
    ``card``: the card's name and power limit."""
    from patchwork_tpu_torch import PatchworkConfig
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.node import NodeParams, PatchworkNode

    cell = bench.cell(workload)
    conf = bench.config(cell.config)
    mix = bench.mix(cell.traffic)
    values = algorithm_values(conf)
    alg = reference.Algorithm.from_dict(values)
    node = PatchworkNode(NodeParams(**conf["node_params"]),
                         PatchworkConfig(**conf["patchwork_config"]),
                         capacity=conf["capacity"],
                         batch_size=mix["batch_size"], device=device)
    if dataclasses.asdict(node.config) != values:
        raise RuntimeError(
            "the node does not run the configuration the file states: "
            f"{dataclasses.asdict(node.config)} != {values}")
    depth = mix.get("pipeline_depth", 2)
    t_pool = time.perf_counter()
    pool = traffic.make_pool(bench.scene(mix["scene"]), conf["sensor"], mix,
                             seed)
    t_warm = time.perf_counter()
    if max(len(s) for s in pool) > conf["capacity"]:
        raise ValueError("a scan holds more points than the node's capacity")

    # set-up: every shape the window uses, run once (the first call loads
    # or builds the kernels)
    node.run(pool, pipeline_depth=depth)
    _sync(device)
    tracer = None
    if trace:
        warm = DeviceTrace(device)
        warm.start()        # the profiler's own first start, out of the window
        node.run(pool[:mix["batch_size"]], pipeline_depth=depth)
        warm.stop()
        tracer = DeviceTrace(device)
    node.times = type(node.times)()
    fit_cuda.reset_launches()

    prof = mix.get("profile", {})
    first = prof.get("from_frame", 0)
    last = first + prof.get("frames", 0) - 1
    traced = set()

    def on_hand(k: int) -> None:
        if tracer is not None and k == first and not tracer.active:
            tracer.start()
        if tracer is not None and tracer.active:
            traced.add(k)

    def on_result(k: int) -> None:
        if tracer is not None and tracer.active and k == last:
            tracer.stop()

    sink = Sink(mix["check_frames"], seed, on_result)
    sinks = [_spanned(sink, "bench.sink")] if trace else [sink]
    wait = (_spanned(traffic.wait_until, "bench.wait_due") if trace
            else traffic.wait_until)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    if mix["arrival"] == "closed":
        source = traffic.ClosedLoop(pool, t_end, on_hand)
        due = None
    elif mix["arrival"] == "open":
        hz = conf["sensor"]["rate_hz"] * mix.get("realtime_factor", 1.0)
        source = traffic.OpenLoop(pool, t0, 1.0 / hz,
                                  math.ceil(seconds * hz - 1e-9), on_hand,
                                  wait)
        due = source.due
    else:
        raise ValueError(f"unknown arrival {mix['arrival']!r}")
    try:
        node.run(source, sinks, pipeline_depth=depth)
    except Exception:       # the run goes on to report what arrived
        log("the node raised:\n" + traceback.format_exc())
    _sync(device)
    t_close = time.perf_counter()
    if tracer is not None and tracer.active:
        tracer.stop()
    stages = node.times.summary()
    engine_calls = stages.get("engine", {}).get("count", 0)
    launches = dict(fit_cuda.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del node
    attempted = len(source.handed) if due is None else len(due)
    log(f"window {seconds} s (closed {t_close - t_end:+.3f} s after its "
        f"end): {attempted} frames attempted, {len(sink.arrived)} results, "
        f"{engine_calls} engine calls; set-up {setup_s:.3f} s: "
        f"{t_pool - t_start:.3f} s to the pool, the pool "
        f"{t_warm - t_pool:.3f} s, the node's warm-up {t0 - t_warm:.3f} s")
    if due is None and seconds >= 4:
        q = np.linspace(t0, t_end, 5)
        log("scans/s by quarter of the window: " + ", ".join(
            f"{sum(1 for t in sink.arrived.values() if a <= t < b) / (b - a):.1f}"
            for a, b in zip(q[:-1], q[1:])))
    log("stage p50 ms: " + ", ".join(
        f"{k} {v['p50_ms']:.3f} (x{v['count']})" for k, v in stages.items()))
    if due is not None and source.handed:
        late = [h - d for h, d in zip(source.handed, due)]
        log(f"generator lateness ms: median {1e3 * np.median(late):.3f}, "
            f"max {1e3 * max(late):.3f}")
    if due is not None and len(due) >= 10:
        lat = [1e3 * (sink.arrived.get(k, math.inf) - d)
               for k, d in enumerate(due)]
        log(f"latency ms: p50 {np.percentile(lat, 50):.3f}, p95 "
            f"{np.percentile(lat, 95):.3f}; p50 by tenth of the window: "
            + ", ".join(f"{np.median(part):.3f}"
                        for part in np.array_split(lat, 10)))

    summary = tracer.summary() if tracer is not None else None
    traced_calls, work_of = 0, None
    if summary is not None:
        for k in summary.kernels[:40]:
            log(f"device op {k.seconds:.6f} s, {k.count} rows: "
                f"{short_name(k.name, 200)}")
        traced_calls = math.ceil(len(traced) / mix["batch_size"])
        work_of = {}
        for k in traced:
            work_of[k % len(pool)] = work_of.get(k % len(pool), 0) + 1
    t_ref = time.perf_counter()
    checks, work = compare(pool, sink, attempted, alg, conf["capacity"],
                           work_of)
    log(f"reference on {len({i % len(pool) for i in sink.counts})} pool "
        f"scans, {len(sink.kept)} frames' masks and {len(sink.counts)} "
        f"frames' counts compared, in {time.perf_counter() - t_ref:.1f} s")

    record = RunRecord(mix["arrival"], t0, t_end, setup_s,
                       source.handed, due, sink.arrived, stages,
                       engine_calls, launches, summary, traced_calls, work,
                       card)
    metrics = {}
    for m in bench.reported(cell.name, trace):
        value = bench.reader(m.name).read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    limits = bench.limits(cell.name)
    correct = all(checks[k] <= limits[k] for k in CHECKS)
    line = {"correct": correct, "attempted": attempted,
            "failed": checks["frames_failed"], "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else
                       device.type, "kind": (
                           torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": peak}}
    if record.trace is not None:
        line["device"]["busy_s"] = record.trace.busy_s
        line["device"]["window_s"] = record.trace.window_s
        line["breakdown"] = record.trace.breakdown()
    line["card"] = card
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in CHECKS}
    return line
