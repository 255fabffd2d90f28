"""The general traffic generator: a pool of scans from the seed, and the
arrivals that hand them to the node.

A mix file (``mixes/<name>.json``) gives its parameters:

- ``scene``: the scene generator, ``traffic/<scene>.py``, whose
  ``scan(n, seed, sensor, **scene_args)`` makes one (n, 3) float32 scan;
- ``scene_args``: keyword arguments of that generator (optional);
- ``pool``: distinct scans made in set-up and cycled;
- ``arrival``: ``"closed"`` (the node pulls the next scan as soon as it
  is ready for it) or ``"open"`` (scan k is due at t0 + k / rate and is
  handed over no earlier);
- ``realtime_factor``: an open loop's rate as a multiple of the sensor's;
- ``batch_size``, ``pipeline_depth``: the node's;
- ``check_frames``: frames whose masks are compared with the reference's;
- ``profile``: ``{"from_frame", "frames"}``, the stretch a traced run
  profiles.

Every seed gets the same point counts (evenly spaced over the
configuration's range) in its own order, so seeds change the scenes and
not the amount of work.  An open loop hands each scan over on time from
an awake process: it sleeps until ``MARGIN_S`` before the due time and
spins on the clock for the rest.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

__all__ = ["MARGIN_S", "pool_sizes", "scan_seed", "make_pool", "wait_until",
           "ClosedLoop", "OpenLoop"]

# An open loop's spin before each due time: longer than the sleep's own
# overshoot, so that a scan is handed over on time.
MARGIN_S = 0.002


def pool_sizes(lo: int, hi: int, pool: int, seed: int) -> np.ndarray:
    """``pool`` point counts spaced evenly over [lo, hi], in an order
    drawn from ``seed``."""
    sizes = np.rint(np.linspace(lo, hi, pool)).astype(np.int64)
    return np.random.default_rng([seed, 1]).permutation(sizes)


def scan_seed(seed: int, pool: int, k: int) -> int:
    """The generator seed of pool scan ``k`` of run seed ``seed``."""
    return seed * pool + k


def make_pool(scene, sensor: dict, mix: dict, seed: int) -> List[np.ndarray]:
    """The mix's pool of scans for ``seed``: (n_k, 3) float32 arrays."""
    p = int(mix["pool"])
    sizes = pool_sizes(sensor["points_min"], sensor["points_max"], p, seed)
    args = mix.get("scene_args", {})
    return [scene.scan(int(n), scan_seed(seed, p, k), sensor, **args)
            for k, n in enumerate(sizes)]


def wait_until(due: float) -> None:
    """Wait until ``due`` (``time.perf_counter()`` seconds): sleep until
    ``MARGIN_S`` before it, then spin on the clock."""
    left = due - time.perf_counter() - MARGIN_S
    if left > 0:
        time.sleep(left)
    while time.perf_counter() < due:
        pass


class ClosedLoop:
    """Scans of ``pool``, cycled, each handed over when the node asks for
    it, until ``t_end`` (host clock).  ``handed[k]``: when scan k was
    handed over; ``on_hand(k)`` runs just before."""

    def __init__(self, pool: List[np.ndarray], t_end: float,
                 on_hand: Optional[Callable[[int], None]] = None):
        self.pool = pool
        self.t_end = t_end
        self.on_hand = on_hand
        self.handed: List[float] = []

    def __iter__(self):
        k = 0
        while time.perf_counter() < self.t_end:
            if self.on_hand is not None:
                self.on_hand(k)
            self.handed.append(time.perf_counter())
            yield self.pool[k % len(self.pool)]
            k += 1


class OpenLoop:
    """``frames`` scans of ``pool``, cycled; scan k is due at
    ``t0 + k * period`` and handed over no earlier.  ``due[k]`` and
    ``handed[k]`` are stamped; ``handed[k] - due[k]`` is how late the
    generator ran.  ``wait(due)`` waits for a due time that has not come
    (``wait_until``, by default)."""

    def __init__(self, pool: List[np.ndarray], t0: float, period: float,
                 frames: int, on_hand: Optional[Callable[[int], None]] = None,
                 wait: Callable[[float], None] = wait_until):
        self.pool = pool
        self.due = [t0 + k * period for k in range(frames)]
        self.on_hand = on_hand
        self.wait = wait
        self.handed: List[float] = []

    def __iter__(self):
        for k, due in enumerate(self.due):
            if due > time.perf_counter():
                self.wait(due)
            if self.on_hand is not None:
                self.on_hand(k)
            self.handed.append(time.perf_counter())
            yield self.pool[k % len(self.pool)]
