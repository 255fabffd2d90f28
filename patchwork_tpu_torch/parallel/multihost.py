"""Joining a multi-process ``torch.distributed`` group.

Counterpart of ``patchwork_tpu/parallel/multihost.py``.  The JAX package
runs one process per host over a global mesh; here each rank is one
process with one device (a card, or the CPU), and every rank runs the same
program over a ``DeviceMesh`` (:func:`.mesh.make_mesh`).  Call
:func:`initialize_multihost` once at start-up in every process.  Nothing
here reads a cluster's environment beyond the variables ``torchrun`` sets.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "host_summary"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join the ``torch.distributed`` group; returns False (and does
    nothing) when neither the arguments nor the environment name one, as
    the JAX package's no-op does (multihost.py:42-45).

    ``coordinator_address``: ``host:port`` (a TCP rendezvous) or any
    ``init_method`` URL, such as ``file:///path`` for a ``FileStore``;
    without it, ``MASTER_ADDR:MASTER_PORT``.  ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.  ``backend``:
    ``nccl`` when a card is present, else ``gloo``, unless named; two ranks
    on one card need ``gloo``.  Returns True once the group is joined (at
    once if it already is)."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs a coordinator address, a "
                         "number of processes and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_summary() -> str:
    """``process r/W: L local / G global devices``: one device per rank,
    so L is 1 and G the group's size (1 / 1 outside a group)."""
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    return f"process {rank}/{world}: 1 local / {world} global devices"
