"""The process mesh, the batch layouts and every collective of ``parallel/``.

Counterpart of ``patchwork_tpu/parallel/mesh.py``.  The JAX package runs one
program over a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives.  Here each device is one OS process, a rank of a
``torch.distributed`` group (:mod:`.multihost` joins it), and
:func:`make_mesh` lays the ranks out as a ``DeviceMesh`` of shape (dp, sp):
scans split over ``dp``, the points of a scan over ``sp``.  The engines
issue their own collectives, all of them through this module:

* :func:`ordered_sum`: an ``all_gather`` of the partials, then their sum in
  rank order.  ``all_reduce(SUM)`` is not used on floats: neither NCCL nor
  gloo promises an order of addition, and every rank has to hold the same
  bits, because loop counts (the engines' fit loops, bundle adjustment's
  CG) are read from reduced values and a rank that ran one collective fewer
  would hang the group;
* :func:`all_min` / :func:`all_max`: ``all_reduce`` of MIN / MAX, exact in
  any order, and :func:`all_sum`, ``all_reduce`` of SUM on integers (the
  order statistic's histograms), exact in any order too;
* :func:`all_gather`, and through it the layouts' ``join``.

``group=None`` in these helpers means this process alone, which is how an
engine runs unsharded; neither it nor a group of one rank issues a
collective.  gloo on CUDA tensors: every
collective here stages a CUDA tensor through host memory when the group's
backend is gloo (a copy to the host, the collective, a copy back), the
path two ranks on one card take (NCCL refuses two ranks on one device);
NCCL takes CUDA tensors as they are.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device
from ..segment.segops import Ranks

__all__ = ["DATA_AXIS", "POINT_AXIS", "make_mesh", "axis_index",
           "axis_size", "BatchLayout", "scan_batch_sharding", "replicated",
           "all_gather", "ordered_sum", "all_sum", "all_min", "all_max",
           "ranks_over", "replicated_max_diff"]

DATA_AXIS = "dp"
POINT_AXIS = "sp"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """A (dp, sp) ``DeviceMesh`` named ("dp", "sp") over ranks
    0..n_devices-1 of the joined group (all of them by default); with only
    ``n_devices`` given, every rank goes to the data axis.  ``device_type``
    defaults to the card (``core.device.resolve_device``, which raises
    without one); the CPU only when the caller names it.  Every rank of the
    group calls it, in the same order as every other mesh it builds."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed group: call "
                           "initialize_multihost (or init_process_group) "
                           "first")
    if n_devices is None:
        n_devices = dist.get_world_size()
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp = {dp}*{sp} != n_devices {n_devices}")
    if n_devices > dist.get_world_size():
        raise ValueError(f"n_devices {n_devices} > world size "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = resolve_device(None).type
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(dp, sp),
                      mesh_dim_names=(DATA_AXIS, POINT_AXIS))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (one shape on all ranks) in the group's rank
    order, on ``t``'s device; ``[t]``, with no collective, for
    ``group=None`` or a group of one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return [t]
    src = t.contiguous()
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    if t.dtype == torch.bool:
        out = out.view(torch.bool)
    return list(out.to(t.device).unbind(0))


def ordered_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` in rank order, ``((t_0 + t_1) + t_2)
    + ...``: the same bits on every rank; ``t``'s bits for one rank."""
    parts = all_gather(t, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return t
    out = t.detach().clone().contiguous()
    host = _via_host(out, group)
    buf = out.cpu() if host else out
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device) if host else buf


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise SUM over the group's ranks, for integer tensors only
    (exact in any order; floats cross by :func:`ordered_sum`)."""
    if t.is_floating_point():
        raise TypeError("all_sum takes integers; sum floats by ordered_sum")
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_min(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min over the group's ranks (exact in any order)."""
    return _all_reduce(t, group, dist.ReduceOp.MIN)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group's ranks."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def ranks_over(group, first: int = 0) -> Ranks:
    """The generic level engine's ``segops.Ranks`` over ``group``, whose
    ranks hold one scan's points between them (this one from global index
    ``first``): float partials by :func:`ordered_sum`, minima by
    :func:`all_min`, the order statistic's histograms by :func:`all_sum`.
    ``group=None``: ``Ranks(first=first)``, this process alone."""
    if group is None:
        return Ranks(first=first)
    return Ranks(sum=lambda t: ordered_sum(t, group),
                 min=lambda t: all_min(t, group),
                 histograms=lambda h: all_sum(h, group), first=first)


def replicated_max_diff(t: torch.Tensor, group) -> float:
    """max |t - t of the group's first rank| over all ranks (NaN where a
    NaN differs): 0.0 when a value meant to be replicated is."""
    if group is None or dist.get_world_size(group) == 1:
        return 0.0
    ref = all_gather(t, group)[0]
    d = (t - ref).abs()
    d = torch.where(torch.isnan(t) != torch.isnan(ref),
                    torch.full_like(d, float("inf")), torch.nan_to_num(d))
    return float(all_max(d.max().reshape(1), group)[0])


# ---------------------------------------------------------------------------
# layouts of a (B, N, ...) scan batch
# ---------------------------------------------------------------------------

class BatchLayout(NamedTuple):
    """``cut(t)``: this rank's block of a global (B, N, ...) tensor, the same
    on every rank; ``join(block)``: the global tensor back from every
    rank's block, on every rank."""
    cut: Callable
    join: Callable


def _blocks(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} {total} does not divide over {parts} ranks")
    return total // parts


def _cat(parts: list, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def scan_batch_sharding(mesh: DeviceMesh,
                        shard_points: bool = True) -> BatchLayout:
    """The layout of a (B, N, 3) / (B, N) batch that the JAX package writes
    as ``P(dp, sp, None)`` / ``P(dp, sp)``: scans split over dp, points
    over sp when ``shard_points`` (else every sp rank holds whole scans).
    B must divide over dp, and N over sp."""
    dp, sp = axis_size(mesh, DATA_AXIS), axis_size(mesh, POINT_AXIS)
    i, j = axis_index(mesh, DATA_AXIS), axis_index(mesh, POINT_AXIS)
    dp_group = mesh.get_group(DATA_AXIS)
    sp_group = mesh.get_group(POINT_AXIS) if shard_points else None

    def cut(t: torch.Tensor) -> torch.Tensor:
        b = _blocks(t.shape[0], dp, "batch")
        t = t[i * b:(i + 1) * b]
        if sp_group is not None:
            n = _blocks(t.shape[1], sp, "points")
            t = t[:, j * n:(j + 1) * n]
        return t

    def join(block: torch.Tensor) -> torch.Tensor:
        if sp_group is not None:
            block = _cat(all_gather(block, sp_group), 1)
        return _cat(all_gather(block, dp_group), 0)

    return BatchLayout(cut, join)


def replicated(mesh: DeviceMesh) -> BatchLayout:
    """The identity layout: every rank holds the whole array."""
    return BatchLayout(lambda t: t, lambda t: t)
