"""Hand-written CUDA kernels of the engine's main path, with their plain
PyTorch versions.

Port of ``patchwork_tpu/kernels/fit_pallas.py`` for an NVIDIA H100
(sources in ``patchwork_tpu_torch/csrc/``, built by :mod:`._build`).  Four
TPU kernels are on the main path, and each becomes a family here:

=================  ==================================================
family             replaces (patchwork_tpu/kernels/...)
=================  ==================================================
``seg_order_stat`` fit_pallas.py ``seg_order_stat`` / ``_orderstat_kernel``
``apply_sweep``    fit_pallas.py ``fused_apply`` / ``_apply_kernel``
                   (with ``sweep_plan``, built once per level for it)
``moments2_sweep`` fit_pallas.py ``fused_moments2`` / ``_moments2_kernel``
``level``          fit_pallas.py ``level_megakernel`` / ``_level_kernel``
                   (``level_core``: one co-operative launch a level)
``fit_level``      fit_pallas.py ``fit_level_megakernel`` / ``_mega_kernel``
=================  ==================================================

plus ``seg_sum`` (seg_pallas.py ``seg_sum_pallas``), the fixed-order
segment sum that binning and the segment ops use, and ``seg_plan``, the
tile plan of a segment binding that its sums add over.  The other two
seg_pallas.py kernels are in :mod:`.seg_cuda`.

The TPU kernels keep the whole cloud in VMEM and turn every segment op
into a one-hot matmul on the MXU.  None of that carries over: here the
cloud stays in device memory (8 packed scans of 131072 points are 34 MB,
inside the 50 MB L2), segment sums are sequential per-node sums inside a
tile of ``TILE`` points followed by a sum of the tiles in index order, and
min/max/counts use integer atomics, which are exact in any order.  No sweep
uses float atomics, so two runs give the same bits, and every plain
version below adds in exactly the kernel's order: on the same device a
kernel and its plain version agree bit for bit.  A tile that holds no point
of a node adds +0.0 to that node's sum, which changes no bit, so the apply
sweep, the moments2 sweep and ``fit_level`` add only over the tiles that do
hold it, found once per level as a :class:`SweepPlan` (the node ids are
fixed during a fit).

Every wrapper takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per family.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from ..core import timing
from ..core.device import true_div
from ..segment.segops import (SegOps, f32_key, flatten_batch, key_f32,
                              sort_by_segment)

__all__ = [
    "TILE", "sp_width", "LAUNCHES", "reset_launches", "plain",
    "seg_order_stat", "seg_order_stat_rounds_plain", "seg_sum", "SweepPlan",
    "sweep_plan", "seg_plan",
    "apply_sweep",
    "moments2_sweep", "remap_r1", "remap_r1b", "remap_nodes", "remap_points",
    "node_stats",
    "early_outs", "deficient_round", "seed_init", "plane_table",
    "split_decision", "finish_nodes", "fit_sweep_loop", "level_sequence",
    "level_core", "fit_pack", "megakernel_fits", "fit_level", "fit_level_blocks",
    "fit_level_smem_bytes", "fit_level_fits",
]

TILE = 256           # points per partial sum (one CUDA block per tile)
_EPS = 1e-12
_TWO_PI_3 = 2.0943951023931953
_BIG = 3.0e38
_OS_SMEM_LIMIT = 48 * 1024       # bytes of one order-stat block's counters
_SMEM_OPTIN_H100 = 232448        # bytes a block may ask for on an H100


LAUNCHES = {"seg_order_stat": 0, "seg_order_stat_rounds": 0,
            "apply_sweep": 0, "moments2_sweep": 0,
            "level": 0, "seg_sum": 0, "fit_level": 0, "seg_gather": 0,
            "seg_minmax": 0, "sweep_plan": 0, "seg_plan": 0, "run_sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sp_width(num_segs: int) -> int:
    """Node-table width: the segment count rounded up to 128 (as the TPU
    kernels lay it out, so tables compare column for column)."""
    return max(128, ((num_segs + 127) // 128) * 128)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _on_card(*tensors: torch.Tensor | None) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors, after
    checking they share one device and are contiguous.  Anything else raises."""
    ts = [t for t in tensors if t is not None]
    first = ts[0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"unsupported device {first.device}")
        if any(t.device.type != "cpu" for t in ts):
            raise ValueError("tensors on mixed devices")
        return False
    index = first.get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError("tensors on mixed devices")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return True


def _f32(*ts: torch.Tensor) -> None:
    for t in ts:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")


_C_FUNCTIONS: dict = {}     # C entry point -> its ctypes function, at first use


def _c_function(fn_name: str):
    from . import _build

    fn = _C_FUNCTIONS[fn_name] = getattr(_build.load(), fn_name)
    return fn


def _launch(family: str, fn_name: str, tensors: tuple, *scalars) -> None:
    """Call C entry point ``fn_name(pointers..., scalars..., stream)`` on the
    current stream of the tensors' device; ``tensors`` holds the pointer
    arguments (None passes a null pointer), the first one a tensor.  Raises
    on a failed launch and counts a good one for ``family``."""
    fn = _C_FUNCTIONS.get(fn_name) or _c_function(fn_name)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(tensors[0].get_device())
    rc = fn(*ptrs, *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")
    LAUNCHES[family] += 1


_WORKSPACE: dict = {}      # (device, stream) -> zeroed int32 scratch


def _workspace(dev: torch.device, ints: int) -> torch.Tensor:
    """``ints`` zeroed int32 of scratch on the current stream of ``dev``,
    for kernels that leave what they use zeroed again (their last block
    clears it): calls in stream order share it, and no launch fills it."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < ints:
        ws = _WORKSPACE[key] = torch.zeros(max(ints, 1 << 16),
                                           dtype=torch.int32, device=dev)
    return ws[:ints]


def _check_points(pts: torch.Tensor, state: torch.Tensor | None = None):
    if pts.dim() != 3 or pts.shape[1] != 8:
        raise ValueError(f"pts must be (B, 8, N), got {tuple(pts.shape)}")
    if pts.shape[2] % TILE:
        raise ValueError(f"N={pts.shape[2]} is not a multiple of {TILE}")
    if state is not None and (state.shape[0] != pts.shape[0]
                              or state.shape[1] != 4
                              or state.shape[2] != pts.shape[2]):
        raise ValueError(f"state must be (B, 4, N), got {tuple(state.shape)}")
    _f32(pts, state)


# ---------------------------------------------------------------------------
# plain building blocks
# ---------------------------------------------------------------------------

def _tile_sums(rows: torch.Tensor, seg: torch.Tensor, sp: int) -> torch.Tensor:
    """(B, R, N) rows summed per segment -> (B, R, sp), in the kernels'
    order: inside each tile of TILE points a sequential sum per segment in
    point order, then the tiles' partial sums in tile order."""
    b, r, n = rows.shape
    nt = n // TILE
    v = rows.reshape(b, r, nt, TILE)
    s = seg.to(torch.int64).reshape(b, 1, nt, TILE).expand(b, r, nt, TILE)
    acc = rows.new_zeros(b, r, nt, sp)
    for t in range(TILE):
        idx = s[..., t:t + 1]
        acc.scatter_(3, idx, acc.gather(3, idx) + v[..., t:t + 1])
    out = rows.new_zeros(b, r, sp)
    for j in range(nt):
        out = out + acc[:, :, j]
    return out


def _gather_rows(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, R, sp) node rows -> (B, R, N) per-point rows of node ``seg``."""
    idx = seg.to(torch.int64)[:, None, :].expand(-1, table.shape[1], -1)
    return torch.gather(table, 2, idx)


def _live(state: torch.Tensor, trash: int):
    """(live seg as int64, activity as 0/1 float) from state row 3."""
    segf = state[:, 3]
    return segf.to(torch.int64), (segf < trash).to(torch.float32)


# ---------------------------------------------------------------------------
# seg_order_stat  (fit_pallas.py:691-731 seg_order_stat -> _orderstat_kernel)
# ---------------------------------------------------------------------------

_OS_SHIFTS = (25, 18, 11, 4, 0)   # key bits resolved a round: 7, 4 last


def _os_pick(hist, r, lo, kw):
    """The select of round ``r`` over summed (M, 128) int32 histograms:
    the first bucket whose inclusive count exceeds kw (128 where none
    does); returns the new (lo, kw), lo an unsigned 32-bit key in int64."""
    cum = torch.cumsum(hist.to(torch.int64), 1)
    j = (cum <= kw[:, None]).sum(1)
    jc = torch.clamp(j, max=127)[:, None]
    below = (cum.gather(1, jc) - hist.to(torch.int64).gather(1, jc))[:, 0]
    kw = kw - torch.where(j < 128, below, torch.zeros_like(below))
    if r == 0:
        lo = ((j - 64) << 25) & 0xFFFFFFFF
    else:
        lo = (lo + (j << _OS_SHIFTS[r])) & 0xFFFFFFFF
    return lo, kw


def _os_signed(lo: torch.Tensor) -> torch.Tensor:
    """An unsigned 32-bit key held in int64 -> its int32 value."""
    return torch.where(lo >= 2 ** 31, lo - 2 ** 32, lo)


def seg_order_stat_rounds_plain(vals, seg, valid, k, num_segs, reduce):
    """The per-round entry's plain version: the five histogram rounds of
    ``_orderstat_rounds`` over the segments with k >= 0, ``reduce`` applied
    to every round's (M, 128) int32 histogram before its select; 0.0 for
    the other segments."""
    b, n = vals.shape
    with timing.span(timing.READ):     # the selection's size
        sel = (k.reshape(-1) >= 0).nonzero()[:, 0]
    m = sel.numel()
    out = torch.zeros(b * num_segs, dtype=torch.float32, device=vals.device)
    if m == 0:
        return out.reshape(b, num_segs)
    slot_of = torch.full((b * num_segs,), -1, dtype=torch.int64,
                         device=vals.device)
    slot_of[sel] = torch.arange(m, device=vals.device)
    seg64 = seg.to(torch.int64)
    inside = valid & (seg64 >= 0) & (seg64 < num_segs)
    flat = flatten_batch(torch.where(inside, seg64, 0), num_segs)
    slot = torch.where(inside.reshape(-1), slot_of[flat], -1)
    mine = slot >= 0
    key = f32_key(vals).reshape(-1)[mine].to(torch.int64)
    slot = slot[mine]
    lo = torch.zeros(m, dtype=torch.int64, device=vals.device)
    kw = k.reshape(-1)[sel].to(torch.int64)
    for r, shift in enumerate(_OS_SHIFTS):
        if r == 0:
            bkt, ok = (key >> 25) + 64, torch.ones_like(key, dtype=torch.bool)
        else:
            d = key - _os_signed(lo)[slot]
            ok = (d >= 0) & (d < (128 << shift))
            bkt = d >> shift
        hist = torch.bincount((slot * 128 + bkt)[ok], minlength=m * 128)
        hist = reduce(hist.to(torch.int32).reshape(m, 128))
        lo, kw = _os_pick(hist, r, lo, kw)
    out[sel] = key_f32(_os_signed(lo).to(torch.int32))
    return out.reshape(b, num_segs)


def seg_order_stat_plain(vals, seg, valid, k, num_segs, reduce=None):
    """Exact per-segment k-th smallest value, by a (segment, key) sort; with
    ``reduce``, :func:`seg_order_stat_rounds_plain`."""
    if reduce is not None:
        return seg_order_stat_rounds_plain(vals, seg, valid, k, num_segs,
                                           reduce)
    b, n = vals.shape
    flat = flatten_batch(seg, num_segs)
    flat = torch.where(valid.reshape(-1), flat,
                       torch.full_like(flat, b * num_segs))
    ss = sort_by_segment(flat, vals.reshape(-1), b * num_segs)
    return ss.order_stat(k.reshape(-1)).reshape(b, num_segs)


def seg_order_stat(vals: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                   k: torch.Tensor, num_segs: int,
                   reduce=None) -> torch.Tensor:
    """Exact per-segment k-th smallest value, ``sorted(vals of seg)[k]``.

    vals (B, N) f32, seg (B, N) int32 in [0, num_segs), valid (B, N) bool,
    k (B, num_segs) int32.  Returns (B, num_segs) f32; segments with no
    candidate or k out of range return garbage (mask downstream).

    CUDA: three launches.  The points are counted per segment, their
    order-preserving int32 keys written segment by segment into a (B, N)
    buffer (in no order inside a segment: the k-th smallest of a multiset
    needs none), and a block per (scan, segment) then runs the five
    histogram rounds of ``_orderstat_rounds`` (7 key bits per round, 4 in
    the last) over its own keys, 128 buckets in shared memory, with no
    launch between the rounds.  Counts are integers, so the result is
    exact.  Bound by the latency of the passes, not by its 9 bytes a point:
    every point is read twice and its key five times out of the L2.

    ``reduce``: the per-round entry, for a scan whose points lie on several
    processes.  A callable applied to every round's (M, 128) int32
    histogram of the M segments with k >= 0 (every process passes the same
    k, read from reduced counts): an ``all_reduce`` of SUM over the
    processes.  Passes 1 and 2 once (one C call, two kernels), then a
    launch a round that selects from the previous round's reduced
    histogram and counts this process's keys into the current 128
    buckets, and a last select: 7 C calls counted under
    ``LAUNCHES["seg_order_stat_rounds"]``, 8 kernels.  The other segments
    return 0.0.  Its plain version is :func:`seg_order_stat_rounds_plain`.
    """
    if not _on_card(vals, seg, valid, k):
        return seg_order_stat_plain(vals, seg, valid, k, num_segs, reduce)
    _f32(vals)
    if seg.dtype != torch.int32 or k.dtype != torch.int32:
        raise TypeError("seg and k must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    b, n = vals.shape
    if seg.shape != (b, n) or valid.shape != (b, n) or k.shape != (b, num_segs):
        raise ValueError("seg_order_stat: shape mismatch")
    if 2 * num_segs * 4 > _OS_SMEM_LIMIT:
        raise ValueError(f"num_segs={num_segs} exceeds the shared counters")
    if reduce is not None:
        return _seg_order_stat_rounds(vals, seg, valid, k, num_segs, reduce)
    out = torch.empty((b, num_segs), dtype=torch.float32, device=vals.device)
    # per segment: its count, what of its range is taken, where it starts
    work = torch.zeros((3, b, num_segs), dtype=torch.int32,
                       device=vals.device)
    keys = torch.empty((b, n), dtype=torch.int32, device=vals.device)
    _launch("seg_order_stat", "pw_seg_order_stat",
            (vals, seg, valid, k, out, work[0], work[1], work[2], keys), b, n,
            num_segs)
    return out


def _seg_order_stat_rounds(vals, seg, valid, k, num_segs, reduce):
    """The per-round entry on the card (see :func:`seg_order_stat`)."""
    b, n = vals.shape
    dev = vals.device
    with timing.span(timing.READ):     # the selection's size
        sel = (k.reshape(-1) >= 0).nonzero()[:, 0].to(torch.int32)
    m = sel.numel()
    out = torch.zeros((b, num_segs), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    work = torch.zeros((3, b, num_segs), dtype=torch.int32, device=dev)
    keys = torch.empty((b, n), dtype=torch.int32, device=dev)
    _launch("seg_order_stat_rounds", "pw_os_prepare",
            (vals, seg, valid, work[0], work[1], work[2], keys), b, n,
            num_segs)
    state = torch.empty((m, 2), dtype=torch.int32, device=dev)
    hist = None
    for r in range(len(_OS_SHIFTS)):
        local = torch.empty((m, 128), dtype=torch.int32, device=dev)
        _launch("seg_order_stat_rounds", "pw_os_round_launch",
                (keys, work[0], work[2], sel, k, hist, state, local), m, n,
                num_segs, r)
        hist = reduce(local).contiguous()
    _launch("seg_order_stat_rounds", "pw_os_final_launch",
            (sel, hist, state, out), m)
    return out


# ---------------------------------------------------------------------------
# seg_sum  (seg_pallas.py:74-93 seg_sum_pallas -> _seg_sum_kernel)
# ---------------------------------------------------------------------------

def _pad_tiles(rows: torch.Tensor, seg: torch.Tensor):
    pad = (-rows.shape[2]) % TILE
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
        seg = torch.nn.functional.pad(seg, (0, pad))
    return rows.contiguous(), seg.contiguous()


def seg_sum_plain(rows, seg, num_segs):
    rows, seg = _pad_tiles(rows, seg)
    return _tile_sums(rows, seg, num_segs)


def _pad_ids(t: torch.Tensor) -> torch.Tensor:
    """Pad the last dimension of ids or a mask to a TILE multiple with 0
    (False), as :func:`_pad_tiles` pads a sum's ids."""
    pad = (-t.shape[-1]) % TILE
    if pad:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], -1)
    return t.contiguous()


def seg_sum(rows: torch.Tensor, seg: torch.Tensor, num_segs: int,
            plan: SweepPlan | None = None) -> torch.Tensor:
    """Fixed-order segment sum: rows (B, R, N) f32, seg (B, N) int32 in
    [0, num_segs) -> (B, R, num_segs).  N is zero-padded to a TILE multiple
    (padded points add +0.0 to segment 0, which changes no bit).  ``plan``
    is :func:`seg_plan` of ``seg``, which a segment binding builds once
    (``SegOps``).

    CUDA, one launch, no float atomics, the order of ``_tile_sums``.  Over
    a plan: a block per (tile, scan) stages its rows at the planned places,
    a thread per (run, row) adds its run in point order, the block writes
    K x R partials (K nodes in the tile) and the block that writes a
    node's last partial adds them in tile order.  Without one (binning's
    sum, ids new on every call) the kernel finds each tile's runs in
    shared memory, writes a present node's partials at (tile, node) of a
    (tiles, S, R) buffer it never fills and marks the tile in the node's
    bitmap row; the last block of a scan adds each node's marked tiles in
    order.  That route was measured against a plan built for the call and
    the planned sum at binning's shape (B=8 x 131072, 81 segments): it is
    faster by event time on every input, by device time on random-order
    ids (PERF.md), so a call with no plan takes it at every shape.  Both
    are bound by a node in every tile, whose chain waits for all its
    partials; the rows are read once.
    """
    if not _on_card(rows, seg):
        return seg_sum_plain(rows, seg, num_segs)
    _f32(rows)
    if seg.dtype != torch.int32:
        raise TypeError("seg must be int32")
    b, r, _ = rows.shape
    if not 1 <= r <= 8:
        raise ValueError("seg_sum takes 1..8 rows")
    rows, seg = _pad_tiles(rows, seg)
    n = rows.shape[2]
    out = torch.empty((b, r, num_segs), dtype=torch.float32, device=rows.device)
    if plan is None:
        nt = n // TILE
        ws = _workspace(rows.device, b * (num_segs * ((nt + 31) // 32) + 1))
        partial = torch.empty((b, nt, num_segs, r), dtype=torch.float32,
                              device=rows.device)
        _launch("seg_sum", "pw_seg_sum", (rows, seg, partial, ws, out), b, r,
                n, num_segs)
        return out
    _check_seg_plan(plan, seg, num_segs)
    _launch("seg_sum", "pw_seg_sum_planned",
            (rows, *plan.tensors(), plan.done, plan.partial(r), out), b, r, n,
            num_segs, plan.cap)
    return out


# ---------------------------------------------------------------------------
# apply_sweep  (fit_pallas.py:179-216 fused_apply -> _apply_kernel; the
# level kernel's inner `sweep`, fit_pallas.py:1305-1336)
# ---------------------------------------------------------------------------

def _sweep_rows(fast: bool) -> int:
    return 12 if fast else 6


@dataclasses.dataclass
class SweepPlan:
    """Which nodes occur in which tile of TILE points, for sums that add
    only over the tiles that hold a node (csrc/tile_sums.cuh).  A tile's
    distinct nodes, in order of first occurrence, are its slots; slot k of
    tile j is entry ``tile_off[j] + k`` of the scan.

    pos (B, N) uint8: a point's place in its tile stably sorted by slot;
    start (B, N) uint8: ``[j * TILE + k]`` where slot k's run starts;
    tile_node (B, N) int32: ``[j * TILE + k]`` slot k's node; tile_off
    (B, N / TILE + 1) int32; node_off (B, sp + 1) int32: prefix sums of the
    nodes' entry counts; dest (B, cap) int32: an entry's place among the
    scan's partials, where node s's lie from ``node_off[s]`` on in tile
    order.  start, tile_node and dest are 0 beyond what the scan uses.  On
    the card it also carries the per-node counters and the partials of the
    passes over it, so a fit (or a segment binding) allocates them once,
    and the stream it was last used on (a segment binding's plan)."""

    pos: torch.Tensor
    start: torch.Tensor
    tile_node: torch.Tensor
    tile_off: torch.Tensor
    node_off: torch.Tensor
    dest: torch.Tensor
    sp: int
    done: torch.Tensor | None = None
    _partial: torch.Tensor | None = None
    stream: int | None = None

    @property
    def cap(self) -> int:
        return self.dest.shape[1]

    def partial(self, rows: int) -> torch.Tensor:
        """Scratch for (B, cap, rows) tile partials."""
        need = self.dest.numel() * rows
        if self._partial is None or self._partial.numel() < need:
            self._partial = torch.empty(need, dtype=torch.float32,
                                        device=self.dest.device)
        return self._partial

    def tensors(self):
        return (self.pos, self.start, self.tile_node, self.tile_off,
                self.node_off, self.dest)

    def sweep_tensors(self):
        """What a one-launch sweep takes: the plan and its counts."""
        return (self.pos, self.start, self.tile_node, self.tile_off,
                self.node_off, self.dest, self.done)

    def fits(self, pts: torch.Tensor, sp: int) -> bool:
        """Whether this is a plan for (B, 8, N) points ``pts`` and width sp."""
        return (self.sp == sp and self.pos.shape == (pts.shape[0], pts.shape[2])
                and self.pos.device == pts.device)


def _plan_cap(n: int, sp: int) -> int:
    """Most entries a scan can have: min(TILE, sp) per tile."""
    return (n // TILE) * min(TILE, sp)


def sweep_plan_plain(state, sp):
    return _plan_plain(state[:, 3].to(torch.int64), sp)


def _plan_plain(seg, sp):
    b, n = seg.shape
    nt = n // TILE
    dev = seg.device
    pos = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    start = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    tile_node = torch.zeros((b, n), dtype=torch.int32, device=dev)
    tile_off = torch.zeros((b, nt + 1), dtype=torch.int32, device=dev)
    node_off = torch.zeros((b, sp + 1), dtype=torch.int32, device=dev)
    dest = torch.zeros((b, _plan_cap(n, sp)), dtype=torch.int32, device=dev)
    earlier = torch.ones((TILE, TILE), dtype=torch.bool, device=dev).tril(-1)
    ar = torch.arange(TILE, device=dev)
    for i in range(b):
        s = seg[i].reshape(nt, TILE)
        eq = s[:, :, None] == s[:, None, :]             # [tile, point, other]
        rank = (eq & earlier).sum(2)                    # same node, earlier
        is_first = rank == 0
        first = eq.to(torch.uint8).argmax(2)            # first point of node
        slot = (torch.cumsum(is_first, 1) - 1).gather(1, first)
        k = is_first.sum(1)
        cnt = torch.zeros_like(s).scatter_add_(1, slot, torch.ones_like(s))
        run = torch.cumsum(cnt, 1) - cnt
        pos[i] = (run.gather(1, slot) + rank).reshape(n).to(torch.uint8)
        used = ar[None] < k[:, None]
        start[i] = torch.where(used, run, 0).reshape(n).to(torch.uint8)
        tile_off[i, 1:] = torch.cumsum(k, 0)
        nodes = s[is_first]              # entry -> node (tile-major, by slot)
        by_slot = torch.zeros_like(s)
        by_slot[used] = nodes
        tile_node[i] = by_slot.reshape(n)
        # a stable sort by node keeps a node's entries in tile order
        order = torch.argsort(nodes, stable=True)
        dest[i, order] = torch.arange(order.numel(), dtype=torch.int32,
                                      device=dev)
        node_off[i, 1:] = torch.cumsum(torch.bincount(nodes, minlength=sp), 0)
    return SweepPlan(pos, start, tile_node, tile_off, node_off, dest, sp)


def sweep_plan(state: torch.Tensor, sp: int) -> SweepPlan:
    """The :class:`SweepPlan` of the node ids in ``state`` row 3 (B, 4, N),
    ids in [0, sp).  Built once per level: the fit loop changes row 0 only.

    CUDA: three small kernels in one call.  A block per tile finds the
    tile's slots, places and run starts in shared memory and sets the
    tile's bit in each present node's bitmap row (integer OR); a block per
    scan turns the slot counts and the rows' set bits into prefix sums; a
    block per tile gives each entry its place, its node's offset plus the
    count of set bits below the tile's, which is tile order without a sort.  Bound
    by reading the ids once; its cost is spread over the level's sweeps.
    """
    if not _on_card(state):
        return sweep_plan_plain(state, sp)
    _f32(state)
    if state.dim() != 3 or state.shape[1] != 4 or state.shape[2] % TILE:
        raise ValueError(f"state must be (B, 4, N), N a multiple of {TILE}, "
                         f"got {tuple(state.shape)}")
    b, _, n = state.shape
    plan, bitmap = _plan_buffers(b, n, sp, state.device)
    _launch("sweep_plan", "pw_sweep_plan",
            (state, plan.pos, plan.start, plan.tile_node, plan.tile_off,
             bitmap, plan.node_off, plan.dest), 4, 3, b, n, sp, plan.cap)
    return plan


def seg_plan(seg: torch.Tensor, num_segs: int) -> SweepPlan:
    """The :class:`SweepPlan` of a segment binding's ids, seg (B, N) int32 in
    [0, num_segs), zero-padded to a TILE multiple as the sums pad them; its
    width ``sp`` is ``num_segs``.  A binding (``SegOps``) builds it once on
    the card and hands it to every :func:`seg_sum` of the binding.  On the
    CPU it is the plain plan, for tests: the plain versions add densely and
    take none.

    CUDA: the three kernels of :func:`sweep_plan` reading int ids, in one
    call counted under ``"seg_plan"``."""
    seg = _pad_ids(seg)
    if not _on_card(seg):
        return _plan_plain(seg.to(torch.int64), num_segs)
    if seg.dtype != torch.int32 or seg.dim() != 2:
        raise TypeError("seg must be (B, N) int32")
    b, n = seg.shape
    plan, bitmap = _plan_buffers(b, n, num_segs, seg.device)
    plan.stream = torch._C._cuda_getCurrentRawStream(seg.get_device())
    _launch("seg_plan", "pw_seg_plan",
            (seg, plan.pos, plan.start, plan.tile_node, plan.tile_off, bitmap,
             plan.node_off, plan.dest), b, n, num_segs, plan.cap)
    return plan


def _check_seg_plan(plan: SweepPlan, seg: torch.Tensor, num_segs: int):
    """Raise unless ``plan`` is a card plan of (B, N) padded ids ``seg`` at
    width num_segs; where the caller moved to another stream since the
    plan's last use, order the current stream after that one (the plan's
    counters and partials are shared in stream order)."""
    if (plan.sp != num_segs or plan.pos.shape != seg.shape
            or plan.pos.device != seg.device or plan.stream is None):
        raise ValueError("the segment plan does not fit these ids")
    index = seg.get_device()
    cur = torch._C._cuda_getCurrentRawStream(index)
    if cur != plan.stream:
        now = torch.cuda.current_stream(index)
        now.wait_stream(torch.cuda.ExternalStream(plan.stream, device=index))
        for t in (*plan.sweep_tensors(), plan._partial):
            if t is not None:
                t.record_stream(now)
        plan.stream = cur


def _plan_buffers(b, n, sp, dev):
    """A card plan's tensors and its build scratch, the zeroed bitmap: one
    zeroed and one uninitialised allocation, cut into views."""
    nt = n // TILE
    cap = _plan_cap(n, sp)
    words = (nt + 31) // 32

    def cut(buf, shapes):
        out, at = [], 0
        for rows, cols, dtype in shapes:
            size = rows * cols // (4 if dtype == torch.uint8 else 1)
            out.append(buf[at:at + size].view(dtype).view(rows, cols))
            at += size
        return out

    # the bitmap's second half holds its words' prefix counts (a card plan
    # built by pw_sweep_plan or pw_seg_plan)
    zeroed = [(b, n, torch.uint8), (b, n, torch.int32), (b, cap, torch.int32),
              (b, sp, torch.int32), (2 * b, sp * words, torch.int32)]
    raw = [(b, n, torch.uint8), (b, nt + 1, torch.int32),
           (b, sp + 1, torch.int32)]
    start, tile_node, dest, done, bitmap = cut(torch.zeros(
        b * (n // 4 + n + cap + sp + 2 * sp * words), dtype=torch.int32,
        device=dev), zeroed)
    pos, tile_off, node_off = cut(torch.empty(
        b * (n // 4 + nt + 1 + sp + 1), dtype=torch.int32, device=dev), raw)
    return SweepPlan(pos, start, tile_node, tile_off, node_off, dest, sp,
                     done=done), bitmap


def apply_sweep_plain(pts, state, tab, trash, fast, plan=None):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    g = state[:, 0].clone()
    gat = _gather_rows(tab, seg)
    dx, dy, dz = x - gat[:, 0], y - gat[:, 1], z - gat[:, 2]
    dist = torch.abs(dx * gat[:, 3] + dy * gat[:, 4] + dz * gat[:, 5])
    apply_m = act * gat[:, 6]
    new_g = (dist < gat[:, 7]).to(torch.float32)
    g2 = apply_m * new_g + (1.0 - apply_m) * g
    state[:, 0] = g2
    gm = g2 * act
    xg, yg, zg = x * gm, y * gm, z * gm
    rows = [gm, xg, yg, zg, dist * g * act,
            apply_m * torch.abs(new_g - g)]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return _tile_sums(torch.stack(rows, 1), seg, tab.shape[2])


def apply_sweep(pts: torch.Tensor, state: torch.Tensor, tab: torch.Tensor,
                trash: int, fast: bool,
                plan: SweepPlan | None = None) -> torch.Tensor:
    """One apply sweep of the fit loop; updates ``state`` row 0 in place.

    pts (B, 8, N) rows [x, y, z, ...]; state (B, 4, N) rows [ground, done,
    chosen, seg]; tab (B, 8, Sp) rows [cx, cy, cz, nx, ny, nz, can, tau].
    Per point: distance to its node's plane, ``ground = dist < tau`` where
    the point is live (seg < trash) and its node may update (can), the
    expression of fit_pallas.py:1314-1319.  Returns per-node sums
    (B, R, Sp), R = 6 rows [cnt, sx, sy, sz (of the new mask), distsum
    (old mask), changed], plus 6 raw second moments [xx, xy, xz, yy, yz,
    zz] of the new mask in fast mode (R = 12).

    ``plan`` is :func:`sweep_plan` of ``state``; a fit loop builds it once
    and hands it to every sweep (row 3 does not change during a fit).
    Without one the sweep builds its own, which costs three more launches
    and two allocations: a caller that sweeps in a loop must pass a plan.

    CUDA: one launch, one block per (tile, scan).  Bound by memory, 24
    bytes read and 4 written per point, and below that by the latency of
    the in-order sums.  Each thread computes one point and stages its rows
    in shared memory at the point's place in the tile sorted by node (the
    plan); one thread per (present node, row) adds its run in point order
    and the block writes K x R floats, K the tile's node count, each node's
    partials next to each other in tile order.  The block that writes a
    node's last partial (an integer count per node) adds them up, so the
    chains run on many SMs beside the tiles still at work.  No
    (tiles, R, Sp) buffer exists and no second launch.  Loads are one
    coalesced 4-byte load per thread and row, overlapped by the six blocks
    an SM holds; a ring of tiles filled by asynchronous copies was
    measured and was slower (PERF.md).
    """
    if not _on_card(pts, state, tab):
        return apply_sweep_plain(pts, state, tab, trash, fast)
    _check_points(pts, state)
    _f32(tab)
    b, _, n = pts.shape
    sp = tab.shape[2]
    r = _sweep_rows(fast)
    if plan is None:
        plan = sweep_plan(state, sp)
    elif not plan.fits(pts, sp):
        raise ValueError("the sweep plan does not fit these points")
    out = pts.new_empty((b, r, sp))
    _launch("apply_sweep", "pw_apply_sweep",
            (pts, state, tab, *plan.sweep_tensors(), plan.partial(r), out),
            b, n, sp, plan.cap, trash, int(fast))
    return out


# ---------------------------------------------------------------------------
# moments2_sweep  (fit_pallas.py:219-244 fused_moments2 -> _moments2_kernel;
# the level kernel's `m2_sweep`, fit_pallas.py:1338-1355)
# ---------------------------------------------------------------------------

def moments2_sweep_plain(pts, state, ctab, trash, plan=None):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    g = state[:, 0] * act
    c = _gather_rows(ctab, seg)
    dx = (x - c[:, 0]) * g
    dy = (y - c[:, 1]) * g
    dz = (z - c[:, 2]) * g
    rows = [dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz]
    return _tile_sums(torch.stack(rows, 1), seg, ctab.shape[2])


def moments2_sweep(pts: torch.Tensor, state: torch.Tensor, ctab: torch.Tensor,
                   trash: int, plan: SweepPlan | None = None) -> torch.Tensor:
    """Centered second-moment sums [xx, xy, xz, yy, yz, zz] per node of the
    live ground mask about the node centroids ctab (B, 3, Sp) -> (B, 6, Sp).

    ``plan`` is :func:`sweep_plan` of ``state``, the one the fit's apply
    sweeps use; without one the sweep builds its own (three more launches
    and two allocations), so a caller that sweeps in a loop passes it.

    CUDA: one launch over the plan, as :func:`apply_sweep` and with its
    tail: a block per (tile, scan) stages six products per point at the
    point's planned place, adds each present node's run in point order and
    writes K x 6 partials; the block that writes a node's last partial adds
    them in tile order.  Bound by memory (20 bytes read per point), and
    below that by the latency of the in-order sums.  The plan's counts and
    partials are shared with the apply sweep: the two alternate on one
    stream and each leaves the counts at zero.
    """
    if not _on_card(pts, state, ctab):
        return moments2_sweep_plain(pts, state, ctab, trash)
    _check_points(pts, state)
    _f32(ctab)
    b, _, n = pts.shape
    sp = ctab.shape[2]
    if ctab.shape != (b, 3, sp):
        raise ValueError(f"ctab must be ({b}, 3, Sp), got {tuple(ctab.shape)}")
    if plan is None:
        plan = sweep_plan(state, sp)
    elif not plan.fits(pts, sp):
        raise ValueError("the sweep plan does not fit these points")
    out = pts.new_empty((b, 6, sp))
    _launch("moments2_sweep", "pw_moments2_sweep",
            (pts, state, ctab, *plan.sweep_tensors(), plan.partial(6), out),
            b, n, sp, plan.cap, trash)
    return out


# ---------------------------------------------------------------------------
# level family  (fit_pallas.py:1465-1558 level_megakernel -> _level_kernel):
# the kernels of one engine level other than the sweeps above.  Per-point
# kernels are bound by memory (one pass over the packed points each);
# per-node kernels are one thread per node and bound by launch latency.
# ---------------------------------------------------------------------------

def remap_r1_plain(pts, trash, sp, fast):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    a = (pseg < trash).to(torch.float32)
    xa, ya = x * a, y * a
    rows = [a, xa, ya] + ([x * xa, y * ya] if fast else [])
    return _tile_sums(torch.stack(rows, 1), pseg.to(torch.int64), sp)


def _dense_scratch(pts, r, sp):
    """What a sum with no plan (``pw_dense_sum_tile``) takes beside its
    inputs: partials (B, tiles, sp, r), which it never fills, the zeroed
    workspace it leaves zeroed, and the (B, r, sp) result."""
    b, _, n = pts.shape
    nt = n // TILE
    ws = _workspace(pts.device, b * (sp * ((nt + 31) // 32) + 1))
    partial = torch.empty((b, nt, sp, r), dtype=torch.float32,
                          device=pts.device)
    return partial, ws, pts.new_empty((b, r, sp))


def remap_r1(pts: torch.Tensor, trash: int, sp: int, fast: bool) -> torch.Tensor:
    """R1 (fit_pallas.py:885-903): per-parent sums [cnt, sx, sy] of the live
    points (parent id = pts row 3), plus raw [xx, yy] in fast mode.

    CUDA: one launch, the segment sum's route with no plan (parent ids are
    new on every call): a block per (tile, scan) computes its points' rows,
    finds its tile's runs in shared memory and writes each present parent's
    partial; the scan's last block adds them in tile order."""
    if not _on_card(pts):
        return remap_r1_plain(pts, trash, sp, fast)
    _check_points(pts)
    b, _, n = pts.shape
    partial, ws, out = _dense_scratch(pts, 5 if fast else 3, sp)
    _launch("level", "pw_remap_r1", (pts, partial, ws, out), b, n, sp, trash,
            int(fast))
    return out


def remap_r1b_plain(pts, cxy, trash):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    ps = pseg.to(torch.int64)
    a = (pseg < trash).to(torch.float32)
    c = _gather_rows(cxy, ps)
    dx = (x - c[:, 0]) * a
    dy = (y - c[:, 1]) * a
    return _tile_sums(torch.stack([dx * dx, dy * dy], 1), ps, cxy.shape[2])


def remap_r1b(pts: torch.Tensor, cxy: torch.Tensor, trash: int) -> torch.Tensor:
    """R1 second pass, exact mode (fit_pallas.py:910-928): per-parent
    centered [sum dx^2, sum dy^2] about the parent centroid cxy (B, 2, Sp).
    CUDA: one launch, as :func:`remap_r1`."""
    if not _on_card(pts, cxy):
        return remap_r1b_plain(pts, cxy, trash)
    _check_points(pts)
    _f32(cxy)
    b, _, n = pts.shape
    sp = cxy.shape[2]
    partial, ws, out = _dense_scratch(pts, 2, sp)
    _launch("level", "pw_remap_r1b", (pts, cxy, partial, ws, out), b, n, sp,
            trash)
    return out


def remap_nodes_plain(tables, median, axis, trash):
    b, _, sp = tables.shape
    split = tables[:, 6]
    rank = torch.cumsum(split, dim=1) - split
    base = 2.0 * rank
    okp = split * ((base + 1.0) < trash).to(torch.float32)
    pnode = torch.stack([median, okp, base, axis], 1)
    dest = torch.where(okp > 0.5, base.to(torch.int64),
                       torch.full_like(base, sp, dtype=torch.int64))
    dest = dest[:, None, :].expand(b, 2, sp)
    tz = tables.new_zeros(b, 2, sp + 2)
    tz.scatter_(2, dest, tables[:, 0:2])
    tz.scatter_(2, dest + 1, tables[:, 0:2])
    return pnode, tz[:, :, :sp].contiguous()


def remap_nodes(tables: torch.Tensor, median: torch.Tensor, axis: torch.Tensor,
                trash: int):
    """R3 + R4 (fit_pallas.py:961-982), one block per scan, the child slots
    a prefix sum over the parents: compact child slots (2 * #earlier split
    parents; overflow keeps its mask) and the children's inherited tau/zth
    rows.

    Returns (pnode (B, 4, Sp) rows [median, ok, base_slot, axis_x] per
    parent, tz (B, 2, Sp) rows [tau, zth] per child slot)."""
    if not _on_card(tables, median, axis):
        return remap_nodes_plain(tables, median, axis, trash)
    _f32(tables, median, axis)
    b, _, sp = tables.shape
    pnode = torch.empty((b, 4, sp), dtype=torch.float32, device=tables.device)
    tz = torch.empty((b, 2, sp), dtype=torch.float32, device=tables.device)
    _launch("level", "pw_remap_nodes", (tables, median, axis, pnode, tz), b,
            sp, trash)
    return pnode, tz


def remap_points_plain(pts, state, pnode, trash):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    a = (pseg < trash).to(torch.float32)
    g = _gather_rows(pnode, pseg.to(torch.int64))
    med, okg, slot, ax = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    v = ax * x + (1.0 - ax) * y
    gr = (v > med).to(torch.float32)
    newseg = okg * (slot + gr) + (1.0 - okg) * trash
    state[:, 3] = a * newseg + (1.0 - a) * trash
    state[:, 1] = torch.maximum(state[:, 1], a * (1.0 - okg))


def remap_points(pts: torch.Tensor, state: torch.Tensor, pnode: torch.Tensor,
                 trash: int) -> None:
    """R5 (fit_pallas.py:984-1010): each live point moves to its parent's
    left (value <= median) or right child slot; points of overflowing
    parents are done.  Writes state rows 1 and 3 in place."""
    if not _on_card(pts, state, pnode):
        return remap_points_plain(pts, state, pnode, trash)
    _check_points(pts, state)
    _f32(pnode)
    b, _, n = pts.shape
    _launch("level", "pw_remap_points", (pts, state, pnode), b, n,
            pnode.shape[2], trash)


def node_stats_plain(pts, state, zth, trash, sp):
    from .seg_cuda import seg_minmax_plain   # seg_cuda imports this module

    seg, act = _live(state, trash)
    live = act > 0.5
    ops = SegOps(seg, sp)
    cnt = ops.count(live).to(torch.float32)
    if zth is None:
        seed = torch.zeros_like(cnt)
    else:
        seedm = live & (pts[:, 2] < torch.gather(zth, 1, seg))
        seed = ops.count(seedm).to(torch.float32)
    mins, maxs = seg_minmax_plain(pts[:, 0:3], seg, live, sp)
    return torch.cat([cnt[:, None], seed[:, None], mins, maxs], 1)


def node_stats(pts: torch.Tensor, state: torch.Tensor, zth: torch.Tensor | None,
               trash: int, sp: int) -> torch.Tensor:
    """Phase 1 (fit_pallas.py:1012-1054): per live node (B, 8, Sp) rows
    [cnt, seed_cnt, xmin, ymin, zmin, xmax, ymax, zmax]; seed_cnt counts
    z < zth[node] (zeros when ``zth`` is None).  Empty nodes: +inf mins,
    -inf maxs.  Min and max compare as order-preserving int keys
    (``seg_minmax``'s order: -0.0 below +0.0, a NaN where its bits put
    it).  CUDA: shared-memory integer atomics per block (counts, and
    min/max on order-preserving int keys), one global atomic per touched
    node per block."""
    if not _on_card(pts, state, zth):
        return node_stats_plain(pts, state, zth, trash, sp)
    _check_points(pts, state)
    _f32(zth)
    b, _, n = pts.shape
    work = torch.empty((b, 8, sp), dtype=torch.int32, device=pts.device)
    out = torch.empty((b, 8, sp), dtype=torch.float32, device=pts.device)
    _launch("level", "pw_node_stats", (pts, state, zth, work, out), b, n, sp,
            trash)
    return out


def early_out_masks(cnt, seed, mins, maxs, real, is_level0, flat_area,
                    flat_dz, flat_minpts, min_seed):
    """Early-outs in the reference's order (cpp:111-140), per node: from the
    counts (B, S), bbox (B, 3, S) each and the real-node mask, the bool
    masks (finished, label, fit, deficient)."""
    too_small = cnt < 3.0
    area = (maxs[:, 0] - mins[:, 0]) * (maxs[:, 1] - mins[:, 1])
    if is_level0:
        flat_a = torch.zeros_like(too_small)
    else:
        flat_a = (area < flat_area) & ~too_small
    flat_z = (maxs[:, 2] - mins[:, 2]) < flat_dz
    flat_z = flat_z & (cnt > float(flat_minpts)) & ~too_small & ~flat_a
    finished = real & (too_small | flat_a | flat_z)
    fit = real & ~finished
    return finished, flat_a | flat_z, fit, fit & (seed < float(min_seed))


def early_outs_plain(nstats, tables, zth, is_level0, flat_area, flat_dz,
                     flat_minpts, min_seed):
    finished, label, fit, deficient = early_out_masks(
        nstats[:, 0], nstats[:, 1], nstats[:, 2:5], nstats[:, 5:8],
        tables[:, 2] > 0.5, is_level0, flat_area, flat_dz, flat_minpts,
        min_seed)
    flags = torch.stack([finished.float(), label.float(), fit.float(),
                         deficient.float(), zth], 1)
    return flags, deficient.any(dim=1).to(torch.int32)


def early_outs(nstats: torch.Tensor, tables: torch.Tensor, zth: torch.Tensor,
               is_level0: bool, flat_area: float, flat_dz: float,
               flat_minpts: int, min_seed: int):
    """Phase 2 (fit_pallas.py:1104-1118), one thread per node, in the
    reference's order (cpp:111-140).  Returns (flags (B, 5, Sp) rows
    [finished, label, fit, deficient, zth], any_deficient (B,) int32)."""
    if not _on_card(nstats, tables, zth):
        return early_outs_plain(nstats, tables, zth, is_level0, flat_area,
                                flat_dz, flat_minpts, min_seed)
    _f32(nstats, tables, zth)
    b, _, sp = nstats.shape
    flags = torch.empty((b, 5, sp), dtype=torch.float32, device=nstats.device)
    any_def = torch.zeros((b,), dtype=torch.int32, device=nstats.device)
    _launch("level", "pw_early_outs", (nstats, tables, zth, flags, any_def),
            b, sp, int(is_level0), float(flat_area), float(flat_dz),
            int(flat_minpts), int(min_seed))
    return flags, any_def


def deficient_round_plain(pts, state, flags, any_def, trash):
    from .seg_cuda import seg_minmax_plain

    sp = flags.shape[2]
    z, idx = pts[:, 2], pts[:, 6]
    seg, act = _live(state, trash)
    def_pt = torch.gather(flags[:, 3], 1, seg) > 0.5
    chosen = state[:, 2]
    cand = (act > 0.5) & def_pt & (chosen < 0.5)
    ops = SegOps(seg, sp)
    # the lowest z in the kernels' key order (a +NaN is never the lowest)
    m = seg_minmax_plain(z[:, None], seg, cand, sp)[0][:, 0]
    m_pt = ops.gather(torch.where(torch.isfinite(m), m, _BIG))
    is_min = cand & (z == m_pt)
    mi = ops.min(idx, is_min)
    mi_pt = ops.gather(torch.where(torch.isfinite(mi), mi, _BIG))
    pick = is_min & (idx == mi_pt)
    state[:, 2] = torch.maximum(chosen, pick.to(torch.float32))


def deficient_round(pts: torch.Tensor, state: torch.Tensor, flags: torch.Tensor,
                    any_def: torch.Tensor, trash: int) -> None:
    """One round of phase 3 (fit_pallas.py:1120-1193): every deficient node
    picks its lowest-z not yet chosen point (ties: lowest index) into state
    row 2.  CUDA: min z, then min index, by integer atomics; scans without
    a deficient node return at once."""
    if not _on_card(pts, state, flags, any_def):
        return deficient_round_plain(pts, state, flags, any_def, trash)
    _check_points(pts, state)
    b, _, n = pts.shape
    sp = flags.shape[2]
    mins = torch.empty((b, 2, sp), dtype=torch.int32, device=pts.device)
    _launch("level", "pw_deficient_round",
            (pts, state, flags, any_def, mins), b, n, sp, trash)


def seed_init_plain(pts, state, flags, trash, fast, plan=None):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    f = _gather_rows(flags, seg)
    fin_pt, lab_pt, fit_pt, def_pt, zth_pt = (f[:, 0], f[:, 1], f[:, 2],
                                              f[:, 3], f[:, 4])
    seed = act * (z < zth_pt).to(torch.float32)
    chosen = state[:, 2]
    seed = (def_pt * chosen + (1.0 - def_pt) * seed) * act
    g = state[:, 0]
    w_fin = act * fin_pt
    g = w_fin * lab_pt + (1.0 - w_fin) * g
    w_fit = act * fit_pt
    g = w_fit * seed + (1.0 - w_fit) * g
    state[:, 0] = g
    state[:, 1] = torch.maximum(state[:, 1], w_fin)
    gm = g * act
    xg, yg, zg = x * gm, y * gm, z * gm
    zero = torch.zeros_like(gm)
    rows = [gm, xg, yg, zg, zero, zero]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return _tile_sums(torch.stack(rows, 1), seg, flags.shape[2])


def seed_init(pts: torch.Tensor, state: torch.Tensor, flags: torch.Tensor,
              trash: int, fast: bool,
              plan: SweepPlan | None = None) -> torch.Tensor:
    """Phase 4 fused with the fit loop's first moment sweep
    (fit_pallas.py:1371-1409): early-out labels and seeds into state rows
    0-1, then the same (B, R, Sp) sums as :func:`apply_sweep` with zero
    distance and changed rows.  ``plan`` is :func:`sweep_plan` of ``state``,
    the one the fit's sweeps that follow add over (built here if None).

    CUDA: one launch over the plan, the apply sweep's scheme and tail."""
    if not _on_card(pts, state, flags):
        return seed_init_plain(pts, state, flags, trash, fast)
    _check_points(pts, state)
    _f32(flags)
    b, _, n = pts.shape
    sp = flags.shape[2]
    r = _sweep_rows(fast)
    if plan is None:
        plan = sweep_plan(state, sp)
    elif not plan.fits(pts, sp):
        raise ValueError("the sweep plan does not fit these points")
    out = pts.new_empty((b, r, sp))
    _launch("level", "pw_seed_init",
            (pts, state, flags, *plan.sweep_tensors(), plan.partial(r), out),
            b, n, sp, plan.cap, trash, int(fast))
    return out


def _normal_rows(m2: torch.Tensor, gcnt: torch.Tensor):
    """``_plane_rows`` (fit_pallas.py:311-377) term for term, with acos in
    place of the TPU's polynomial ``_acos``: (B, 6, Sp) centered second
    moment sums -> unit normals (vx, vy, vz), flipped to +Z."""
    denom = torch.clamp(gcnt - 1.0, min=1.0)
    a00, a01, a02 = m2[:, 0] / denom, m2[:, 1] / denom, m2[:, 2] / denom
    a11, a12, a22 = m2[:, 3] / denom, m2[:, 4] / denom, m2[:, 5] / denom

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = true_div(a00 + a11 + a22, 3.0)
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(true_div(p2, 6.0), min=0.0))
    safe_p = torch.clamp(p, min=_EPS)
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = true_div(torch.acos(r), 3.0)
    two_pi_3 = torch.tensor(_TWO_PI_3, dtype=torch.float32, device=m2.device)
    e_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    diag_min = torch.minimum(a00, torch.minimum(a11, a22))
    e_min = torch.where(p <= _EPS, diag_min, e_lo)

    r0x, r0y, r0z = a00 - e_min, a01, a02
    r1x, r1y, r1z = a01, a11 - e_min, a12
    r2x, r2y, r2z = a02, a12, a22 - e_min
    c0x = r0y * r1z - r0z * r1y
    c0y = r0z * r1x - r0x * r1z
    c0z = r0x * r1y - r0y * r1x
    c1x = r0y * r2z - r0z * r2y
    c1y = r0z * r2x - r0x * r2z
    c1z = r0x * r2y - r0y * r2x
    c2x = r1y * r2z - r1z * r2y
    c2y = r1z * r2x - r1x * r2z
    c2z = r1x * r2y - r1y * r2x

    n0 = torch.sqrt(c0x * c0x + c0y * c0y + c0z * c0z)
    n1 = torch.sqrt(c1x * c1x + c1y * c1y + c1z * c1z)
    n2 = torch.sqrt(c2x * c2x + c2y * c2y + c2z * c2z)
    sel0 = (n0 >= n1) & (n0 >= n2)
    sel1 = ~sel0 & (n1 >= n2)
    vx = torch.where(sel0, c0x, torch.where(sel1, c1x, c2x))
    vy = torch.where(sel0, c0y, torch.where(sel1, c1y, c2y))
    vz = torch.where(sel0, c0z, torch.where(sel1, c1z, c2z))
    nn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = nn > 1e-20
    sn = torch.clamp(nn, min=1e-30)
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    vx = torch.where(ok, vx / sn, zero)
    vy = torch.where(ok, vy / sn, zero)
    vz = torch.where(ok, vz / sn, one)
    flip = vz < 0
    return (torch.where(flip, -vx, vx), torch.where(flip, -vy, vy),
            torch.where(flip, -vz, vz))


def _centered_m2(m1: torch.Tensor) -> torch.Tensor:
    """Raw fast-sweep moments -> centered sums, ``_centered_m2``
    (fit_pallas.py:380-396): cov sums = M2 - S S^T / n."""
    n = torch.clamp(m1[:, 0], min=1.0)
    sx, sy, sz = m1[:, 1], m1[:, 2], m1[:, 3]
    return torch.stack([m1[:, 6] - sx * sx / n, m1[:, 7] - sx * sy / n,
                        m1[:, 8] - sx * sz / n, m1[:, 9] - sy * sy / n,
                        m1[:, 10] - sy * sz / n, m1[:, 11] - sz * sz / n], 1)


def plane_table_plain(m1, c, m2, fit, tau, fast):
    gcnt = m1[:, 0]
    if fast:
        m2 = _centered_m2(m1)
    vx, vy, vz = _normal_rows(m2, gcnt)
    if fit is None:
        can = torch.zeros_like(gcnt)
    else:
        can = fit * (gcnt >= 3.0).to(torch.float32)
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, can, tau], 1)


def plane_table(m1: torch.Tensor, c: torch.Tensor, m2: torch.Tensor | None,
                fit: torch.Tensor | None, tau: torch.Tensor,
                fast: bool) -> torch.Tensor:
    """``make_tab`` (fit_pallas.py:1357-1369), one thread per node: the
    (B, 8, Sp) plane table [cx, cy, cz, nx, ny, nz, can, tau] the next sweep
    reads.  c (B, 3, Sp) centroids; m2 (B, 6, Sp) centered sums in exact
    mode, None in fast mode (taken from m1's raw rows); ``fit`` None gives
    can = 0 (the final residual sweep)."""
    if not _on_card(m1, c, m2, fit, tau):
        return plane_table_plain(m1, c, m2, fit, tau, fast)
    _f32(m1, c, m2, fit, tau)
    if (m2 is None) != fast:
        raise ValueError("m2 is given exactly in exact mode")
    b, r, sp = m1.shape
    tab = m1.new_empty((b, 8, sp))
    _launch("level", "pw_plane_table", (m1, c, m2, fit, tau, tab), b, sp, r,
            int(fast))
    return tab


def split_decision_plain(sf, nstats, flags, tables):
    gcnt = sf[:, 0]
    resid = sf[:, 4] / torch.clamp(gcnt, min=1.0)
    resid = torch.where(gcnt >= 3.0, resid, torch.full_like(resid, float("inf")))
    split = ((flags[:, 2] > 0.5) & (resid > tables[:, 3])
             & (nstats[:, 0] >= tables[:, 4]) & (tables[:, 5] > 0.5))
    return torch.stack([split.to(torch.float32), gcnt, resid], 1)


def split_decision(sf: torch.Tensor, nstats: torch.Tensor, flags: torch.Tensor,
                   tables: torch.Tensor) -> torch.Tensor:
    """Phase 6 (fit_pallas.py:1427-1439), one thread per node: from the
    final sweep's sums -> (B, 3, Sp) rows [split, gcnt, resid]; resid is
    +inf below 3 ground points."""
    if not _on_card(sf, nstats, flags, tables):
        return split_decision_plain(sf, nstats, flags, tables)
    _f32(sf, nstats, flags, tables)
    b, r, sp = sf.shape
    out = torch.empty((b, 3, sp), dtype=torch.float32, device=sf.device)
    _launch("level", "pw_split_decision", (sf, nstats, flags, tables, out),
            b, sp, r)
    return out


def finish_nodes_plain(state, flags, sd, trash):
    seg, act = _live(state, trash)
    fit_pt = torch.gather(flags[:, 2], 1, seg) > 0.5
    split_pt = torch.gather(sd[:, 0], 1, seg) < 0.5
    fin2 = (act > 0.5) & fit_pt & split_pt
    state[:, 1] = torch.maximum(state[:, 1], fin2.to(torch.float32))


def finish_nodes(state: torch.Tensor, flags: torch.Tensor, sd: torch.Tensor,
                 trash: int) -> None:
    """Phase 7 (fit_pallas.py:1441-1458): points of fitted nodes that do
    not split are done (state row 1, in place)."""
    if not _on_card(state, flags, sd):
        return finish_nodes_plain(state, flags, sd, trash)
    _f32(state, flags, sd)
    b, _, n = state.shape
    _launch("level", "pw_finish_nodes", (state, flags, sd), b, n,
            flags.shape[2], trash)


# ---------------------------------------------------------------------------
# the whole level (_level_kernel, fit_pallas.py:789-1462): as a sequence of
# the phases above around the loop of sweeps, and in one launch
# ---------------------------------------------------------------------------

def fit_sweep_loop(k, pts, state, m1, fit_row, tau_row, trash, max_iter, fast,
                   plan=None):
    """The fit while-loop of a level (fit_pallas.py:1357-1425) as a loop of
    the sweeps of ``k`` (this module or :data:`plain`): from the sums ``m1``
    of the seeded mask, plane table then apply sweep until no scan changed
    or max_iter, then the final can = 0 sweep whose sums give the residual.
    That sweep runs only on a max_iter exit: after a convergence exit the
    mask equals the last sweep's input, so its sums are bitwise those of
    the last sweep.  ``state`` row 0 (the mask) is updated in place; returns
    the final sums (B, R, Sp).  Row 3 (the node ids) is fixed for the loop,
    so one sweep plan (``plan``, built here unless given) serves every
    sweep, the apply sweeps and the moments2 sweeps alike.  The host reads
    one flag per iteration.  It takes any Sp: the sweeps keep their tables
    in device memory."""
    if plan is None:
        plan = k.sweep_plan(state, fit_row.shape[1])

    def make_tab(m1, with_can):
        c = (m1[:, 1:4] / torch.clamp(m1[:, 0:1], min=1.0)).contiguous()
        m2 = None if fast else k.moments2_sweep(pts, state, c, trash, plan)
        return k.plane_table(m1.contiguous(), c, m2,
                             fit_row if with_can else None, tau_row, fast)

    changed = True
    for _ in range(max_iter):
        m1 = k.apply_sweep(pts, state, make_tab(m1, True), trash, fast, plan)
        changed = timing.read((m1[:, 5] > 0.0).any())
        if not changed:
            break
    if changed:
        m1 = k.apply_sweep(pts, state, make_tab(m1, False), trash, fast,
                           plan)
    return m1


def level_fit_plain(pts, state, m1, fit_row, tau_row, trash, max_iter, fast):
    """The fit while-loop of a level from the sums ``m1`` of the seeded mask,
    as the loop of plain sweeps."""
    return fit_sweep_loop(plain, pts, state, m1, fit_row, tau_row, trash,
                          max_iter, fast)


def level_sequence(k, pts, state, tables, trash, max_iter, is_level0,
                   min_seed, flat_area, flat_dz, flat_minpts, fast,
                   remap=None, tz=None, nstats=None):
    """One engine level (after R1, R1b and the medians of a remap level) as
    its phases, each a call of ``k`` (this module, or :data:`plain`), the
    fit as :func:`fit_sweep_loop` over one sweep plan that the seed sums
    share.  Arguments and result as :func:`level_core`; with ``k = plain``
    it is :func:`level_core`'s plain version.  On the card it is the route
    where the one launch cannot hold the node table
    (:func:`fit_level_fits` false): R3-R5, node stats, early-outs, the
    deficient rounds, the seed sums, the fit, the split decision and the
    finish, one or a few launches each."""
    sp = tables.shape[2]
    if remap is not None:
        pnode, tz = k.remap_nodes(tables, remap[0], remap[1], trash)
        k.remap_points(pts, state, pnode, trash)
    elif tz is None:
        tz = tables[:, 0:2]
    tau_row, zth_row = tz[:, 0].contiguous(), tz[:, 1].contiguous()
    if nstats is None:
        nstats = k.node_stats(pts, state, zth_row, trash, sp)
    flags, any_def = k.early_outs(nstats, tables, zth_row, is_level0,
                                  flat_area, flat_dz, flat_minpts, min_seed)
    for _ in range(min_seed):
        k.deficient_round(pts, state, flags, any_def, trash)
    plan = k.sweep_plan(state, sp)
    m1 = k.seed_init(pts, state, flags, trash, fast, plan)
    sf = fit_sweep_loop(k, pts, state, m1, flags[:, 2].contiguous(), tau_row,
                        trash, max_iter, fast, plan)
    sd = k.split_decision(sf, nstats, flags, tables)
    k.finish_nodes(state, flags, sd, trash)
    return torch.stack([sd[:, 0], sd[:, 1], sd[:, 2], nstats[:, 0],
                        nstats[:, 1], tau_row, zth_row,
                        torch.zeros_like(tau_row)], 1)


def _fit_scratch(pts, sp, sweeps_out):
    """What a one-launch fit over (B, 8, N) points takes beside its inputs:
    the plan's buffers with their build scratch, the plane table, the
    zeroed (3, B) flags, barrier counts and sweep counts, and where the
    sweep counts go (``sweeps_out`` if given, checked)."""
    b, _, n = pts.shape
    plan, bitmap = _plan_buffers(b, n, sp, pts.device)
    tab = torch.empty((b, 7, sp), dtype=torch.float32, device=pts.device)
    sync = torch.zeros((3, b), dtype=torch.int32, device=pts.device)
    if sweeps_out is None:
        sweeps_out = sync[2]
    elif (sweeps_out.shape != (b,) or sweeps_out.dtype != torch.int32
          or not _on_card(pts, sweeps_out)):
        raise ValueError("sweeps_out must be (B,) int32 on the points' device")
    return plan, bitmap, tab, sync, sweeps_out


def _level_scratch(b, sp, min_seed, dev):
    """What a level in one launch takes beside the fit's scratch: R3's
    parent rows (B, 4, Sp), the early-out flags (B, 5, Sp) and the node
    stats (B, 8, Sp); zeroed, the node stats' counts and key distances
    (B, 8, Sp), the deficient flags (B,) and the rounds' minima
    (min_seed, B, 2, Sp)."""
    def floats(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def zeroed(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return (floats(b, 4, sp), floats(b, 5, sp), floats(b, 8, sp),
            zeroed(b, 8, sp), zeroed(b), zeroed(min_seed, b, 2, sp))


def level_core_plain(pts, state, tables, trash, max_iter, is_level0, min_seed,
                     flat_area, flat_dz, flat_minpts, fast, remap=None,
                     tz=None, nstats=None):
    return level_sequence(plain, pts, state, tables, trash, max_iter,
                          is_level0, min_seed, flat_area, flat_dz,
                          flat_minpts, fast, remap, tz, nstats)


def level_core(pts: torch.Tensor, state: torch.Tensor, tables: torch.Tensor,
               trash: int, max_iter: int, is_level0: bool, min_seed: int,
               flat_area: float, flat_dz: float, flat_minpts: int,
               fast: bool, remap=None, tz: torch.Tensor | None = None,
               nstats: torch.Tensor | None = None,
               sweeps_out: torch.Tensor | None = None,
               _blocks_per_scan: int = 0) -> torch.Tensor:
    """One engine level after its remap sums (``_level_kernel``,
    fit_pallas.py:789-1462) in one launch.

    pts (B, 8, N) rows [x, y, z, seg, ground, done, index, 0] (seg is the
    parent id on a remap level); state (B, 4, N) rows [ground, done,
    chosen, seg] with rows 0-2 seeded from pts, updated in place (row 3 is
    the node ids, or written here on a remap level); tables (B, 8, Sp).
    ``remap``: (median, axis_x), each (B, Sp) per parent, on a remap level:
    R3-R5 run first.  ``tz`` (B, 2, Sp): tau and zth per node, handed in;
    else the tables' rows 0-1, or R4's on a remap level.  ``nstats``
    (B, 8, Sp): the node stats, handed in with ``tz`` for percentile seeds
    (node stats, the order statistic and R3-R5 then run ahead of this
    call).  Returns the level's stats (B, 8, Sp) rows [split, gcnt, resid,
    cnt, seed_cnt, tau, zth, 0].  ``sweeps_out`` (B,) int32 on the card, if
    given, receives the sweeps each scan ran, sweep 0 (the seeds' sums)
    included.  ``_blocks_per_scan`` is for tests and the timing tool only.

    CUDA: ``fit_level``'s device code reading the level layout, grown into
    the whole level (csrc/fitloop.cu ``pw_fit_level_kernel<FAST, true>``, the phases'
    device code csrc/level.cuh): one co-operative launch, the card's
    co-resident blocks / B blocks per scan, a barrier per scan in device
    memory between the phases, R3-R5, the sweep plan, node stats,
    early-outs, the deficient rounds (in scans with a deficient node), the
    seeds and their sums as sweep 0, the fit loop, the split decision and
    the finish, each scan leaving the fit on its own, no host read.  Bound
    by latency: up to 101 sweeps, each waiting for the sums of the one
    before.  Where :func:`fit_level_fits` is false the launch is refused and
    raises; the engine asks first and takes :func:`level_sequence` there.  A
    batch above the card's co-resident blocks is cut into several launches.
    """
    median, axis = remap if remap is not None else (None, None)
    if not _on_card(pts, state, tables, median, axis, tz, nstats):
        return level_core_plain(pts, state, tables, trash, max_iter,
                                is_level0, min_seed, flat_area, flat_dz,
                                flat_minpts, fast, remap, tz, nstats)
    _check_points(pts, state)
    _f32(tables, median, axis, tz, nstats)
    b, _, n = pts.shape
    sp = tables.shape[2]
    if (tables.shape != (b, 8, sp)
            or any(t is not None and t.shape != (b, sp) for t in (median, axis))
            or (tz is not None and tz.shape != (b, 2, sp))
            or (nstats is not None and nstats.shape != (b, 8, sp))):
        raise ValueError(f"level_core: tables must be ({b}, 8, Sp), median "
                         f"and axis ({b}, Sp), tz ({b}, 2, Sp), nstats "
                         f"({b}, 8, Sp)")
    if nstats is not None and (tz is None or remap is not None):
        raise ValueError("nstats is handed in with tz, after the remap")
    if not 0 <= trash < sp:
        raise ValueError(f"trash={trash} outside the table width {sp}")
    if _blocks_per_scan < 0 or min_seed < 0:
        raise ValueError("_blocks_per_scan and min_seed must be >= 0")
    dev = pts.device
    held = _fit_level_held(sp, fast, True)
    if b > held:
        if sweeps_out is None:
            sweeps_out = torch.empty(b, dtype=torch.int32, device=dev)

        def cut(t, i):
            return None if t is None else t[i:i + held]

        return torch.cat([
            level_core(pts[i:i + held], state[i:i + held], tables[i:i + held],
                       trash, max_iter, is_level0, min_seed, flat_area,
                       flat_dz, flat_minpts, fast,
                       None if remap is None else (cut(median, i),
                                                   cut(axis, i)),
                       cut(tz, i), cut(nstats, i), sweeps_out[i:i + held],
                       _blocks_per_scan)
            for i in range(0, b, held)])
    out = torch.empty((b, 8, sp), dtype=torch.float32, device=dev)
    plan, bitmap, tab, sync, sweeps_out = _fit_scratch(pts, sp, sweeps_out)
    _launch("level", "pw_level_core",
            (pts, state, tables, median, axis, tz, nstats, out, plan.pos,
             plan.start, plan.tile_node, plan.tile_off, bitmap,
             plan.node_off, plan.dest, plan.partial(_sweep_rows(fast)), tab,
             *_level_scratch(b, sp, min_seed, dev), sync[0], sync[1],
             sweeps_out), b, n, sp, plan.cap, int(trash),
            int(max_iter), int(fast), int(_blocks_per_scan),
            fit_level_smem_bytes(sp, fast, True), int(is_level0),
            int(min_seed), int(flat_minpts), float(flat_area), float(flat_dz))
    return out


# ---------------------------------------------------------------------------
# fit_level  (fit_pallas.py:523-560 fit_level_megakernel -> _mega_kernel):
# one level's whole fit loop in one launch, for the generic level engine
# ---------------------------------------------------------------------------

def fit_pack(xyz: torch.Tensor, tau_pt: torch.Tensor, amask: torch.Tensor,
             seg: torch.Tensor) -> torch.Tensor:
    """The fit layout (fit_pallas.py:70-86): xyz (B, 3, N), tau (B, N),
    apply-mask (B, N) bool, seg (B, N) -> (B, 8, N) rows [x, y, z, tau,
    amask, seg (exact as f32), 0, 0]."""
    rows = [tau_pt.to(torch.float32), amask.to(torch.float32),
            seg.to(torch.float32)]
    zero = torch.zeros_like(rows[0])
    return torch.cat([xyz.to(torch.float32),
                      torch.stack(rows + [zero, zero], 1)], 1).contiguous()


def megakernel_fits(n_padded: int, sp: int) -> bool:
    """The JAX package's VMEM gate (fit_pallas.py:516-520), carried over
    verbatim.  It decides one thing in the port: level path or generic
    path, so the port takes the JAX package's path at every N and the two
    can be held against each other path by path.  In exact mode it changes
    no result (every path adds in the sweeps' order).  Whether a fit runs
    in one launch is the card's own question, :func:`fit_level_fits`."""
    point_bytes = (8 + 3) * 4 * n_padded          # packed rows + in/out masks
    onehot_bytes = 2 * sp * 4096 * 2              # (Sp, T) bf16, double-ish
    return point_bytes + onehot_bytes + 64 * sp * 4 < 10 * 1024 * 1024


def fit_level_smem_bytes(sp: int, fast: bool, level: bool = False) -> int:
    """Dynamic shared memory of one block of the one-launch fit at table
    width ``sp``, the one place it is computed: the wrappers hand it to the
    launch, and ``pw_fit_level_kernel`` (csrc/fitloop.cu) carves it up as
    the staged rows of a tile, the plane table, the sums of the block's
    nodes (sized for one block per scan), the runs of a tile and the plan's
    scratch (``PW_PLAN_SMEM_INTS``, csrc/tile_sums.cuh).  ``level``: of
    :func:`level_core`, whose table has a tau row, else of
    :func:`fit_level`."""
    r = _sweep_rows(fast)
    floats = (r * TILE + (8 if level else 7) * sp + sp * r
              + (0 if fast else sp * 6))
    return (floats + 2 * TILE + 1 + 3 * TILE + 33) * 4


def fit_level_fits(sp: int, fast: bool, device, level: bool = False) -> bool:
    """The card's gate of the one-launch fit (:func:`fit_level`,
    :func:`level_core`): whether a block's shared memory at table width
    ``sp`` stays inside what the card grants a block (its opt-in limit,
    read from the card; an H100's 227 KB for a CPU tensor, so the plain
    path takes the routes the card takes).  Above it a fit runs as
    :func:`fit_sweep_loop`.  A batch is never refused: it is cut."""
    device = torch.device(device)
    limit = _SMEM_OPTIN_H100
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return fit_level_smem_bytes(sp, fast, level) <= limit


def _fit_sweep_plain(p, g, tab, sp, fast):
    x, y, z, tau, am = p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4]
    seg = p[:, 5].to(torch.int64)
    gat = _gather_rows(tab, seg)
    dx, dy, dz = x - gat[:, 0], y - gat[:, 1], z - gat[:, 2]
    dist = torch.abs(dx * gat[:, 3] + dy * gat[:, 4] + dz * gat[:, 5])
    apply_m = am * gat[:, 6]
    new_g = (dist < tau).to(torch.float32)
    g2 = apply_m * new_g + (1.0 - apply_m) * g
    xg, yg, zg = x * g2, y * g2, z * g2
    rows = [g2, xg, yg, zg, dist * g, apply_m * torch.abs(new_g - g)]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return g2, _tile_sums(torch.stack(rows, 1), seg, sp)


def _fit_table_plain(p, g, m1, sp, fast, with_can):
    gcnt = m1[:, 0]
    c = m1[:, 1:4] / torch.clamp(gcnt[:, None], min=1.0)
    if fast:
        m2 = _centered_m2(m1)
    else:
        cg = _gather_rows(c, p[:, 5].to(torch.int64))
        dx = (p[:, 0] - cg[:, 0]) * g
        dy = (p[:, 1] - cg[:, 1]) * g
        dz = (p[:, 2] - cg[:, 2]) * g
        m2 = _tile_sums(torch.stack([dx * dx, dx * dy, dx * dz, dy * dy,
                                     dy * dz, dz * dz], 1),
                        p[:, 5].to(torch.int64), sp)
    vx, vy, vz = _normal_rows(m2, gcnt)
    can = ((gcnt >= 3.0) & with_can).to(torch.float32)
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, can], 1)


def fit_level_plain(p, g0, num_segs, max_iter, fast):
    b, _, n = p.shape
    sp = sp_width(num_segs)
    g, m1 = _fit_sweep_plain(p, g0[:, 0], p.new_zeros(b, 7, sp), sp, fast)
    changed = True
    for _ in range(max_iter):
        g, m1 = _fit_sweep_plain(p, g, _fit_table_plain(p, g, m1, sp, fast,
                                                        True), sp, fast)
        changed = timing.read((m1[:, 5] > 0.0).any())
        if not changed:
            break
    if changed:
        g, m1 = _fit_sweep_plain(p, g, _fit_table_plain(p, g, m1, sp, fast,
                                                        False), sp, fast)
    return g[:, None], torch.cat([m1[:, :6], p.new_zeros(b, 2, sp)], 1)


def fit_level(p: torch.Tensor, g0: torch.Tensor, num_segs: int,
              max_iter: int, fast: bool = False,
              sweeps_out: torch.Tensor | None = None,
              _blocks_per_scan: int = 0):
    """One level's complete fit loop (``_mega_kernel``) in one launch.

    p (B, 8, N) fit layout (:func:`fit_pack`), N a multiple of TILE; g0
    (B, 1, N) seeded 0/1 mask.  Returns (g (B, 1, N) converged mask,
    stats (B, 8, Sp) rows [cnt, sx, sy, sz, distsum (old mask), changed, 0,
    0] of the final fit).  ``fast`` accumulates raw second moments in the
    apply sweep (one sweep per iteration; expects patch-center-shifted
    coordinates).  ``sweeps_out`` (B,) int32 on the card, if given, receives
    the apply sweeps each scan ran (the work the data asked for).
    ``_blocks_per_scan`` is for tests and the timing tool only (ragged and
    empty tile shares); no result depends on it.

    CUDA: bound by latency, up to 101 sweeps that each need the sums of
    the one before, so the whole card works on them.  Every scan gets the
    card's co-resident blocks / B blocks (:func:`fit_level_blocks`) in one
    co-operative launch; they loop on the device with a barrier per scan
    in device memory, so each scan converges on its own with no host read.
    A block keeps its tiles for the launch, builds their part of the sweep
    plan, writes compact tile partials per sweep, and owns the nodes
    ``s % blocks == block``: their in-order chains, centroid, normal and
    table row.  Sums keep the
    sweeps' order, so the kernel equals its plain version (and the level
    path's fit) bit for bit, whatever the number of blocks.  A launch the
    card cannot hold resident, or whose shared memory exceeds what the card
    grants a block (:func:`fit_level_fits`), is refused and raises.  A batch of more
    scans than the card holds blocks (about 660 on an H100) is cut into
    several launches; a scan's result does not depend on its batch.
    """
    if not _on_card(p, g0):
        return fit_level_plain(p, g0, num_segs, max_iter, fast)
    _check_points(p)
    _f32(g0)
    b, _, n = p.shape
    if g0.shape != (b, 1, n):
        raise ValueError(f"g0 must be ({b}, 1, {n}), got {tuple(g0.shape)}")
    if _blocks_per_scan < 0:
        raise ValueError("_blocks_per_scan must be >= 0")
    sp = sp_width(num_segs)
    dev = p.device
    held = _fit_level_held(sp, fast, False)
    if b > held:
        if sweeps_out is None:
            sweeps_out = torch.empty(b, dtype=torch.int32, device=dev)
        cuts = [fit_level(p[i:i + held], g0[i:i + held], num_segs, max_iter,
                          fast, sweeps_out[i:i + held], _blocks_per_scan)
                for i in range(0, b, held)]
        return (torch.cat([g for g, _ in cuts]),
                torch.cat([st for _, st in cuts]))
    g = torch.empty_like(g0)
    stats = torch.empty((b, 8, sp), dtype=torch.float32, device=dev)
    plan, bitmap, tab, sync, sweeps_out = _fit_scratch(p, sp, sweeps_out)
    _launch("fit_level", "pw_fit_level",
            (p, g0, g, stats, plan.pos, plan.start, plan.tile_node,
             plan.tile_off, bitmap, plan.node_off, plan.dest,
             plan.partial(_sweep_rows(fast)), tab, sync[0], sync[1],
             sweeps_out), b, n, sp, plan.cap, int(max_iter), int(fast),
            int(_blocks_per_scan), fit_level_smem_bytes(sp, fast, False))
    return g, stats


_FIT_LEVEL_HELD: dict = {}


def _fit_level_held(sp: int, fast: bool, level: bool) -> int:
    """Blocks of a :func:`fit_level` (or, ``level``, :func:`level_core`)
    launch the card holds at a time: the most scans one launch takes."""
    key = (torch.cuda.current_device(), sp, bool(fast), bool(level))
    if key not in _FIT_LEVEL_HELD:
        _FIT_LEVEL_HELD[key] = _fit_blocks(1, 1 << 30, sp, fast, level)
    return _FIT_LEVEL_HELD[key]


def _fit_blocks(b: int, n: int, sp: int, fast: bool, level: bool) -> int:
    """Blocks per scan of an automatic one-launch fit on the current card;
    raises above the card's gate (:func:`fit_level_fits`)."""
    from . import _build

    if not fit_level_fits(sp, fast, "cuda", level):
        raise RuntimeError(
            f"the one-launch fit needs {fit_level_smem_bytes(sp, fast, level)}"
            f" bytes of shared memory a block at table width {sp}: above "
            "what the card grants")
    blocks = _build.load().pw_fit_level_blocks(
        b, n, int(fast), int(level), fit_level_smem_bytes(sp, fast, level))
    if blocks <= 0:
        raise RuntimeError(f"pw_fit_level_blocks: CUDA error {-blocks}")
    return blocks


def fit_level_blocks(b: int, n: int, num_segs: int, fast: bool = False,
                     level: bool = False) -> int:
    """Blocks per scan of a :func:`fit_level` (or, ``level``,
    :func:`level_core`) launch on the current card: its co-resident blocks
    divided by ``b``, at most one per tile."""
    return _fit_blocks(b, n, sp_width(num_segs), fast, level)


# The plain versions under the wrappers' names: what the engine calls to
# run the level with no kernel on any device.
plain = types.SimpleNamespace(
    seg_order_stat=seg_order_stat_plain, seg_sum=seg_sum_plain,
    sweep_plan=lambda state, sp: None, apply_sweep=apply_sweep_plain,
    moments2_sweep=moments2_sweep_plain,
    remap_r1=remap_r1_plain, remap_r1b=remap_r1b_plain,
    remap_nodes=remap_nodes_plain, remap_points=remap_points_plain,
    node_stats=node_stats_plain, early_outs=early_outs_plain,
    deficient_round=deficient_round_plain, seed_init=seed_init_plain,
    plane_table=plane_table_plain, split_decision=split_decision_plain,
    finish_nodes=finish_nodes_plain, level_core=level_core_plain,
    fit_level=fit_level_plain,
)
