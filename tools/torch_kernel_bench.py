#!/usr/bin/env python3
"""Check and time the port's redesigned kernels on one NVIDIA card.

    python3 tools/torch_kernel_bench.py [--json PATH] [--sections LIST]

Sections (all by default; ``--sections gather,sweeps`` runs some):

``gather``    ``seg_gather`` on the inputs the generic path gives it (B=8 x
              131072 under ``segment_impl="pallas"``, B=8 x 153600 under the
              default) beside ``torch.gather`` on the prepared int64 index:
              each one's device time (torch.profiler), its time by CUDA
              events over back-to-back calls, and its host time per call
              (``time.perf_counter`` over 2000 unsynchronised calls); and
              the host time per call of the other wrappers, the floor the
              launch plumbing sets for every family's event time;
``sweeps``    the sweep plan, the planned apply sweep and the planned
              moments2 sweep on the level path's inputs (velodyne and split
              terrain, B=8 x 131072) and on the same points shuffled, each
              held to its plain version (bitwise), by events and by device
              time;
``fits``      ``fit_level`` on the level-0 fit of B=8/3/1 x 153600 128-beam
              scans over a range of blocks per scan, beside the loop of
              sweeps;
``level_fit`` the level path's level on the inputs the main path gives it
              (velodyne level 0, Sp 128, and a split-terrain remap level,
              Sp 256; B=8 x 131072; exact and fast): ``engine.level`` by
              events and its device time, all of it and the level family's
              kernels; with ``level_core`` (one launch a level) also the
              launch held to its plain version at max_iter 2 and run twice,
              its device time over a range of blocks per scan, the sweeps
              each scan ran (sweep 0, the seeds', included), beside its
              phases one by one (``level_sequence``: the phase kernels and
              the loop of sweeps); a tree from before it times the level
              only (an A/B in turns);
``order_stat`` ``seg_order_stat`` on the split median (Sp 256) and the
              percentile seeds (Sp 128) of the main path: by events, host
              time per call, and the device time and count of each of its
              kernels per call;
``seg``       the segment ops on the inputs the main path gives them:
              ``seg_sum`` at binning's shape (B=8 x 131072, velodyne and
              split terrain, 81 segments) and at the generic path's deeper
              levels (split terrain B=8 x 153600, 161 segments), on each
              route (a call with no plan, plan + planned, the plan alone,
              over a binding's plan) beside ``index_add_``; ``seg_minmax``
              there; each held to its plain version
              twice, by events and by device time kernel by kernel, with
              its bound (a tree from before the plan times its one route);
``profiles``  one profiled batch per path (device busy time, host span,
              idle share, top kernels), 262144 points and split terrain
              at 153600 on the generic path included; and on the velodyne
              batch its binning alone and the level-0 prologue (binning to
              the first level launch: fast shift, tau and z_th, level 0's
              pack and tables), tools/profile_fused.py's stages;
``scans``     scans/s of ``filter_ground_batched`` at B=8 (CUDA events, 10
              batches after a warm-up): velodyne at 131072 points, 128-beam
              velodyne at 153600 on the generic path and with the level
              path forced, at 262144, and split terrain at 131072 (level
              path) and 153600 (generic path) (not in the default list:
              run the tool in two trees in turns to compare them);
``host``      the generic path's host side on split terrain at 153600:
              host time per ``fit_level`` call and of its scratch, and the
              top functions of five batches under cProfile (not in the
              default list).

Prints the card's name and power limit and what ptxas reported for these
kernels first; exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--sections", default="gather,sweeps,fits,level_fit,"
                    "order_stat,seg,profiles")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.core.device import card_info, cuda_device
    from patchwork_tpu_torch.core.timing import device_busy_ms
    from patchwork_tpu_torch.io.synthetic import (split_terrain_cloud,
                                                  velodyne_like_cloud)
    from patchwork_tpu_torch.kernels import _build, fit_cuda, seg_cuda
    from patchwork_tpu_torch.segment import binning, engine

    dev = cuda_device()
    card = card_info().splitlines()[0]
    print(card, flush=True)
    _build.load()
    log = (_build._BUILD / "nvcc.log").read_text()
    for m in re.finditer(r"Compiling entry function '(\w+)'[^\n]*\n"
                         r"[^\n]*\n\s*([^\n]*spill[^\n]*)\n"
                         r"ptxas info\s+: (Used [^\n]+)", log):
        if re.search(r"apply_kernel|pw_plan_|fit_level|pw_m2|gather|pw_os_|"
                     r"pw_seg_sum|minmax|pw_level|pw_r1|pw_seed",
                     m.group(1)):
            print(f"[ptxas] {m.group(1)}: {m.group(3)}; {m.group(2)}",
                  flush=True)
    bad = []
    out = {"card": card}

    def check(ok, what):
        print(f"[check] {what}: {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            bad.append(what)

    def bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def batch(gen, b, n, **kw):
        xyz = torch.from_numpy(np.stack([gen(n, seed=s, **kw)
                                         for s in range(b)]))
        return xyz.to(dev), torch.ones(xyz.shape[:2], dtype=torch.bool,
                                       device=dev)

    def capture(data, cfg, module, name, pick=1, admits=None):
        """The arguments of the pick-th call of ``name`` in one batch;
        ``admits(sp)`` stands in for the card's gate of the one-launch fit
        (``lambda sp: False``: every fit as a loop of sweeps)."""
        import contextlib

        cap = chip_smoke.Capture(module, [name], {name: pick})
        try:
            with (chip_smoke.card_gate(admits) if admits
                  else contextlib.nullcontext()):
                filter_ground_batched(*data, cfg)
        finally:
            cap.restore()
        return cap.saved[name]

    def no_one_launch(sp):
        return False

    def shuffled(a, seed):
        """The captured sweep input with its points in random order."""
        pts, state, tab, trash, fast = a[:5]
        g = torch.Generator(device="cpu").manual_seed(seed)
        perm = torch.randperm(pts.shape[2], generator=g).to(dev)
        return (pts[:, :, perm].contiguous(), state[:, :, perm].contiguous(),
                tab, trash, fast)

    def check_sweep(label, a):
        pts, state, tab, trash, fast = a[:5]
        sp = tab.shape[2]
        plan = fit_cuda.sweep_plan(state, sp)
        ref = fit_cuda.sweep_plan_plain(state, sp)
        check(all(torch.equal(x, y) for x, y in
                  zip(plan.tensors(), ref.tensors())), f"{label} plan")
        st_k, st_p, st_2 = state.clone(), state.clone(), state.clone()
        got = fit_cuda.apply_sweep(pts, st_k, tab, trash, fast, plan)
        # the moments2 sweep between two apply sweeps, on the same plan
        ctab = tab[:, :3].contiguous()
        m2 = fit_cuda.moments2_sweep(pts, st_k, ctab, trash, plan)
        again = fit_cuda.apply_sweep(pts, st_2, tab, trash, fast, plan)
        want = fit_cuda.apply_sweep_plain(pts, st_p, tab, trash, fast)
        torch.cuda.synchronize()
        check(bits(got, want) and bits(st_k, st_p), f"{label} apply vs plain")
        check(bits(got, again) and bits(st_k, st_2), f"{label} apply twice")
        check(bits(m2, fit_cuda.moments2_sweep_plain(pts, st_p, ctab, trash))
              and bits(m2, fit_cuda.moments2_sweep(pts, st_k, ctab, trash, plan)),
            f"{label} moments2 vs plain and twice")
        total = plan.tile_off[:, -1].float()
        return plan, float(total.mean()) / (pts.shape[2] // fit_cuda.TILE)

    def check_fit(label, p, g0, num_segs, max_iter, fast, blocks):
        g_k, s_k = fit_cuda.fit_level(p, g0, num_segs, max_iter, fast=fast,
                                      _blocks_per_scan=blocks)
        g_2, s_2 = fit_cuda.fit_level(p, g0, num_segs, max_iter, fast=fast,
                                      _blocks_per_scan=blocks)
        g_p, s_p = fit_cuda.fit_level_plain(p, g0, num_segs, max_iter, fast)
        torch.cuda.synchronize()
        check(torch.equal(g_k, g_p) and bits(s_k, s_p),
              f"{label} fit_level vs plain")
        check(torch.equal(g_k, g_2) and bits(s_k, s_2), f"{label} twice")
        return g_k, s_k

    # ---- times at the main path's shapes ----
    B, N, N_GEN = chip_smoke.B, chip_smoke.N, chip_smoke.N_GEN

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_rows(prof):
        """(device us, count, name) of the profile's kernels.  Rows of
        host-side PyTorch ops are left out: an op's self device time is
        that of the kernels it launched, which have rows of their own."""
        from torch.autograd import DeviceType

        rows = []
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t > 0 and ev.device_type == DeviceType.CUDA:
                rows.append((t, ev.count, ev.key))
        return rows

    def device_us(fn, reps, pattern):
        """Mean device time per call of the kernels matching ``pattern``."""
        return 1e3 * device_busy_ms(fn, reps, pattern).busy_ms

    def host_us(fn, reps=2000):
        """Host time per call: ``reps`` calls with no synchronise between
        them (the queue absorbs them), by the host's clock."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    # ---- seg_gather beside torch.gather; the wrappers' host time ----
    def gather_section():
        rows = {}
        cases = {
            f"pallas B={B} N={N}": (
                batch(velodyne_like_cloud, B, N),
                PatchworkConfig(segment_impl="pallas"), 3),
            f"fused B={B} N={N_GEN}": (
                batch(velodyne_like_cloud, B, N_GEN, num_beams=128),
                PatchworkConfig(), 1)}
        for label, (data, cfg, pick) in cases.items():
            (table, seg), _ = capture(data, cfg, seg_cuda, "seg_gather", pick)
            idx = seg.long()[:, None, :].expand(-1, table.shape[1], -1)
            got = seg_cuda.seg_gather(table, seg)
            check(bits(got, torch.gather(table, 2, idx))
                  and bits(got, seg_cuda.seg_gather_plain(table, seg)),
                  f"seg_gather {label} vs torch.gather and plain")

            def kernel():
                return seg_cuda.seg_gather(table, seg)

            def library():
                return torch.gather(table, 2, idx)

            byts = 4 * (table.numel() + seg.numel() + got.numel())
            row = {"shape": [list(table.shape), list(seg.shape)],
                   "bound_us": byts / chip_smoke.PEAK_BYTES_S * 1e6}
            for _ in range(5):      # in turns: kernel, library, kernel, ...
                for name, fn, pat in (
                        ("kernel", kernel, "pw_gather"),
                        ("torch_gather", library, r"^(?!.*pw_).*gather")):
                    r = row.setdefault(name, {"device_us": [], "events_us": [],
                                              "host_us": []})
                    r["device_us"].append(device_us(fn, 200, pat))
                    r["events_us"].append(1e3 * events_ms(fn, 2000))
                    r["host_us"].append(host_us(fn))
            rows[label] = row
            for name in ("kernel", "torch_gather"):
                r = row[name]

                def spread(key):    # least, median, most of the five turns
                    v = sorted(r[key])
                    return f"{v[0]:.2f} / {v[2]:.2f} / {v[-1]:.2f}"

                print(f"[gather] {label} table {tuple(table.shape)} {name} "
                      f"(min / median / max of 5 turns): device "
                      f"{spread('device_us')} us, by events "
                      f"{spread('events_us')} us, host per call "
                      f"{spread('host_us')} us (bound {row['bound_us']:.2f} "
                      f"us, {byts} B)", flush=True)
        out["gather"] = rows

        # the other wrappers' host time per call, on the level path's inputs
        a, _ = capture(batch(velodyne_like_cloud, B, N), PatchworkConfig(),
                       fit_cuda, "apply_sweep", 5, no_one_launch)
        pts, state, tab, trash = a[:4]
        st = state.clone()
        plan = fit_cuda.sweep_plan(st, tab.shape[2])
        m1 = fit_cuda.apply_sweep(pts, st, tab, trash, False, plan)
        c = tab[:, :3].contiguous()
        m2 = fit_cuda.moments2_sweep(pts, st, c, trash, plan)
        fit = tab[:, 6].contiguous()
        tau = tab[:, 7].contiguous()
        host = {}
        for name, fn in (
                ("apply_sweep", lambda: fit_cuda.apply_sweep(
                    pts, st, tab, trash, False, plan)),
                ("moments2_sweep", lambda: fit_cuda.moments2_sweep(
                    pts, st, c, trash, plan)),
                ("plane_table", lambda: fit_cuda.plane_table(
                    m1, c, m2, fit, tau, False)),
                ("torch.empty", lambda: torch.empty(
                    (B, 6, 128), dtype=torch.float32, device=dev))):
            host[name] = {"host_us": host_us(fn),
                          "events_us": 1e3 * events_ms(fn, 2000)}
            print(f"[host] {name}: host per call {host[name]['host_us']:.2f} "
                  f"us, by events {host[name]['events_us']:.2f} us",
                  flush=True)
        out["host"] = host

        # what a seg_gather call is made of, piece by piece (host time)
        (table, seg), _ = capture(batch(velodyne_like_cloud, B, N),
                                  PatchworkConfig(segment_impl="pallas"),
                                  seg_cuda, "seg_gather", 3)
        b, c, s = table.shape
        n = seg.shape[1]
        res = torch.empty((b, c, n), dtype=torch.float32, device=dev)
        fn = fit_cuda._c_function("pw_seg_gather")
        ptrs = [t.data_ptr() for t in (table, seg, res)]
        stream = torch.cuda.current_stream().cuda_stream
        pieces = {}
        for name, piece in (
                ("torch.empty((b, c, n), dtype, device)",
                 lambda: torch.empty((b, c, n), dtype=torch.float32,
                                     device=table.device)),
                ("table.new_empty((b, c, n))",
                 lambda: table.new_empty((b, c, n))),
                ("_on_card(table, seg)",
                 lambda: fit_cuda._on_card(table, seg)),
                ("three data_ptr()",
                 lambda: [t.data_ptr() for t in (table, seg, res)]),
                ("raw stream handle",
                 lambda: torch._C._cuda_getCurrentRawStream(
                     table.get_device())),
                ("torch.cuda.current_stream().cuda_stream",
                 lambda: torch.cuda.current_stream().cuda_stream),
                ("the C call alone (ctypes + launch)",
                 lambda: fn(*ptrs, b, c, n, s, stream)),
                ("a Python call of an empty function", lambda: None)):
            pieces[name] = host_us(piece)
            print(f"[plumbing] {name}: {pieces[name]:.2f} us", flush=True)
        out["plumbing"] = pieces

    if "gather" in sections:
        gather_section()

    sweeps = {}
    scenes = {"velodyne": batch(velodyne_like_cloud, B, N),
              "split": batch(split_terrain_cloud, B, N)}
    for fast in (False, True) if "sweeps" in sections else ():
        cfg = PatchworkConfig(fast_covariance=fast)
        mode = "fast" if fast else "exact"
        for scene, data in scenes.items():
            a, _ = capture(data, cfg, fit_cuda, "apply_sweep", 5,
                           no_one_launch)
            for label, inp in ((scene, a), (scene + " shuffled",
                                            shuffled(a, 2))):
                plan, per_tile = check_sweep(f"{label} {mode}", inp)
                pts, state, tab, trash, _ = inp[:5]
                st = state.clone()
                ctab = tab[:, :3].contiguous()
                row = {
                    "nodes_per_tile": per_tile, "sp": tab.shape[2],
                    "events_us": 1e3 * events_ms(lambda: fit_cuda.apply_sweep(
                        pts, st, tab, trash, fast, plan), 200),
                    "device_us": device_us(lambda: fit_cuda.apply_sweep(
                        pts, st, tab, trash, fast, plan), 50, "pw_apply"),
                    "plan_events_us": 1e3 * events_ms(
                        lambda: fit_cuda.sweep_plan(state, tab.shape[2]), 50),
                    "plan_device_us": device_us(
                        lambda: fit_cuda.sweep_plan(state, tab.shape[2]), 20,
                        "pw_plan"),
                    "moments2_device_us": device_us(
                        lambda: fit_cuda.moments2_sweep(
                            pts, st, ctab, trash, plan), 50, "pw_m2"),
                    "moments2_events_us": 1e3 * events_ms(
                        lambda: fit_cuda.moments2_sweep(
                            pts, st, ctab, trash, plan), 200)}
                sweeps[f"{label} {mode}"] = row
                print(f"[sweep] {label} {mode} B={B} N={N} Sp={row['sp']} "
                      f"nodes/tile {per_tile:.2f}: apply {row['device_us']:.1f}"
                      f" us device, {row['events_us']:.1f} us by events; plan "
                      f"{row['plan_device_us']:.1f} us device, "
                      f"{row['plan_events_us']:.1f} us by events; moments2 "
                      f"{row['moments2_device_us']:.1f} us device, "
                      f"{row['moments2_events_us']:.1f} us by events",
                      flush=True)
    out["sweeps"] = sweeps

    fits = {}
    gen = batch(velodyne_like_cloud, B, N_GEN, num_beams=128)
    for fast in (False, True) if "fits" in sections else ():
        cfg = PatchworkConfig(fast_covariance=fast)
        mode = "fast" if fast else "exact"
        (p, g0, num_segs, max_iter), kw = capture(gen, cfg, fit_cuda,
                                                  "fit_level")
        (fargs, fkw) = capture(gen, cfg, engine, "_fused_fit_resid")
        with chip_smoke.card_gate(no_one_launch):
            loop_ms = chip_smoke._time_ms(engine._fused_fit_resid, fargs, fkw,
                                          3)
        for b in (8, 3, 1):
            pb, gb = p[:b].contiguous(), g0[:b].contiguous()
            auto = fit_cuda.fit_level_blocks(b, N_GEN, num_segs, fast)
            check_fit(f"{mode} B={b} N={N_GEN} G=auto({auto})", pb, gb,
                      num_segs, max_iter, fast, 0)
            for blocks in sorted({auto, 16, 32, 64, 128, 264, 600}):
                if blocks > auto:
                    continue
                ms = events_ms(lambda: fit_cuda.fit_level(
                    pb, gb, num_segs, max_iter, fast=fast,
                    _blocks_per_scan=blocks), 3)
                fits[f"{mode} B={b} G={blocks}"] = ms
                print(f"[fit_level] {mode} B={b} N={N_GEN} blocks/scan "
                      f"{blocks}{' (auto)' if blocks == auto else ''}: "
                      f"{ms:.3f} ms", flush=True)
        fits[f"{mode} loop of sweeps B={B}"] = loop_ms
        print(f"[fit_level] {mode} B={B} N={N_GEN}: the loop of sweeps on the "
              f"same fit {loop_ms:.3f} ms", flush=True)
    out["fit_level_ms"] = fits

    # ---- the level path's level in one launch ----
    def level_fit_section():
        """engine.level on the main path's inputs, its device time by
        kernel family; in a tree with level_core (one launch a level) also
        the launch held to its plain version, over blocks per scan, beside
        its phases one by one.  A tree from before it (its phases as
        launches of their own around a one-launch fit) times the level
        only, for an A/B in turns."""
        rows = {}
        one_launch = hasattr(fit_cuda, "level_core")
        for fast in (False, True):
            cfg = PatchworkConfig(fast_covariance=fast)
            mode = "fast" if fast else "exact"
            for scene, pick in (("velodyne", 1), ("split", 2)):
                (la, lkw) = capture(scenes[scene], cfg, engine, "level", pick)
                sp = la[1].shape[2]
                label = f"{scene} {mode} B={B} N={N} Sp={sp}"
                row = {"level_events_ms": events_ms(
                           lambda: engine.level(*la, **lkw), 10),
                       "level_device_ms": device_us(
                           lambda: engine.level(*la, **lkw), 10, ".") / 1e3,
                       "level_family_device_ms": device_us(
                           lambda: engine.level(*la, **lkw), 10,
                           "pw_(?!seg_|os_|gather|minmax)") / 1e3}
                line = (f"[level_fit] {label}: the level {row['level_events_ms']:.3f}"
                        f" ms by events, {row['level_device_ms']:.4f} ms "
                        f"device, of which the level family's kernels "
                        f"{row['level_family_device_ms']:.4f} ms")
                if one_launch:
                    (a, _) = capture(scenes[scene], cfg, fit_cuda,
                                     "level_core", pick)

                    def run(fn, mi=None, **kw):
                        args = list(a)
                        args[1] = args[1].clone()
                        if mi is not None:
                            args[4] = mi
                        return fn(*args, **kw), args[1]

                    got, again = run(fit_cuda.level_core, 2), \
                        run(fit_cuda.level_core, 2)
                    want = run(fit_cuda.level_core_plain, 2)
                    torch.cuda.synchronize()
                    check(all(bits(x, y) for x, y in zip(got, want)),
                          f"level_core {label} max_iter 2 vs plain")
                    check(all(bits(x, y) for x, y in zip(got, again)),
                          f"level_core {label} twice")
                    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
                    run(fit_cuda.level_core, sweeps_out=sweeps)
                    auto = fit_cuda.fit_level_blocks(B, N, sp, fast,
                                                     level=True)
                    row.update({"sweeps_per_scan": sweeps.tolist(),
                                "auto_blocks": auto, "blocks": {}})
                    for blocks in sorted({auto, 16, 32, 64}):
                        if blocks > auto:
                            continue
                        row["blocks"][blocks] = device_us(lambda: run(
                            fit_cuda.level_core,
                            _blocks_per_scan=blocks), 5,
                            r"pw_fit_level_kernel<\w+, true>") / 1e3
                    row["phases_one_by_one_ms"] = events_ms(lambda: run(
                        lambda *x: fit_cuda.level_sequence(fit_cuda, *x)), 3)
                    line += (f"; the launch {row['blocks'][auto]:.4f} ms "
                             f"device with {auto} blocks a scan (" + ", ".join(
                                 f"{g}: {v:.4f}" for g, v in
                                 sorted(row["blocks"].items()))
                             + f" ms by blocks a scan); its phases one by "
                             f"one {row['phases_one_by_one_ms']:.3f} ms; "
                             f"sweeps per scan {row['sweeps_per_scan']} "
                             "(sweep 0 included)")
                rows[label] = row
                print(line, flush=True)
        out["level_fit"] = rows

    if "level_fit" in sections:
        level_fit_section()

    # ---- the order statistic ----
    def order_stat_section():
        rows = {}
        cases = {
            "median, split remap level": (scenes["split"], PatchworkConfig()),
            "percentile, velodyne level 0": (
                scenes["velodyne"],
                PatchworkConfig(adaptive_seed_height=False))}
        for label, (data, cfg) in cases.items():
            a, _ = capture(data, cfg, fit_cuda, "seg_order_stat")
            vals, seg, valid, k, s = a
            cnt = torch.stack([torch.bincount(seg[i][valid[i]].long(),
                                              minlength=s)[:s]
                               for i in range(seg.shape[0])])
            ok = (k.long() >= 0) & (k.long() < cnt)
            got = fit_cuda.seg_order_stat(*a)
            check(bits(got[ok], fit_cuda.seg_order_stat_plain(*a)[ok])
                  and bits(got, fit_cuda.seg_order_stat(*a)),
                  f"seg_order_stat {label} vs plain and twice")

            def call():
                return fit_cuda.seg_order_stat(*a)

            from torch.profiler import ProfilerActivity, profile

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
            kernels = {key: (t / 50, c / 50) for t, c, key in
                       kernel_rows(prof) if "pw_os_" in key}
            row = {"sp": s, "events_us": 1e3 * events_ms(call, 200),
                   "host_us": host_us(call, 500),
                   "device_us": sum(t for t, _ in kernels.values()),
                   "kernels_per_call": sum(c for _, c in kernels.values()),
                   "kernels": kernels,
                   "bound_us": chip_smoke.kernel_bound(
                       "seg_order_stat", a, {}, got, None)[0] * 1e3}
            rows[label] = row
            print(f"[order_stat] {label} B={vals.shape[0]} N={vals.shape[1]} "
                  f"Sp={s}: {row['events_us']:.1f} us by events, host "
                  f"{row['host_us']:.1f} us a call, device "
                  f"{row['device_us']:.1f} us in {row['kernels_per_call']:.0f} "
                  f"kernels a call (" + ", ".join(
                      f"{key.split('(')[0]} {t:.1f}" for key, (t, _) in
                      sorted(kernels.items())) + f"); bound "
                  f"{row['bound_us']:.2f} us", flush=True)
        out["order_stat"] = rows

    if "order_stat" in sections:
        order_stat_section()

    # ---- the segment ops: #6 seg_sum, #8 seg_minmax, a binding's plan ----
    def first_calls(data, cfg, module, name, label_of):
        """The arguments of the first call of ``module.name`` under each
        label ``label_of(args)`` gives (None: not kept) in one batch.  Its
        own copy of ``chip_smoke.first_calls``, so that the tool also runs
        in a tree from before that function (the parent of an A/B)."""
        saved = {}
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            label = label_of(a)
            if label and label not in saved:
                saved[label] = chip_smoke._clone(a)
            return orig(*a, **kw)

        setattr(module, name, wrapped)
        try:
            filter_ground_batched(*data, cfg)
        finally:
            setattr(module, name, orig)
        return saved

    def seg_section():
        rows = {}
        split_gen = batch(split_terrain_cloud, B, N_GEN)
        # a tree from before the binding's plan times its one route
        bound = hasattr(fit_cuda, "seg_plan")
        sums = {}
        for scene in ("velodyne", "split"):
            for label, a in first_calls(scenes[scene], PatchworkConfig(),
                                        fit_cuda, "seg_sum",
                                        lambda a: "binning").items():
                sums[f"{label} {scene} B={B} N={N}"] = a
        deeper = first_calls(
            split_gen, PatchworkConfig(), seg_cuda, "seg_sum",
            lambda a: f"R={a[0].shape[1]}" if a[2] > 81 else None)
        for label, a in deeper.items():
            sums[f"generic deeper split B={B} N={N_GEN} {label}"] = a
        for label, (x, seg, s) in sums.items():
            want = fit_cuda.seg_sum_plain(x, seg, s)
            calls = {"call": lambda: fit_cuda.seg_sum(x, seg, s)}
            if bound:
                plan = fit_cuda.seg_plan(seg, s)
                calls.update({
                    "plan + planned": lambda: fit_cuda.seg_sum(
                        x, seg, s, plan=fit_cuda.seg_plan(seg, s)),
                    "plan": lambda: fit_cuda.seg_plan(seg, s),
                    "over the binding's plan": lambda: fit_cuda.seg_sum(
                        x, seg, s, plan=plan)})
            for name, fn in calls.items():
                if name != "plan":
                    check(bits(fn(), want) and bits(fn(), want),
                          f"seg_sum {label} {name} vs plain, twice")
            src = x.permute(0, 2, 1).reshape(-1, x.shape[1]).contiguous()
            idx = (seg.long() + s * torch.arange(B, device=dev)[:, None]
                   ).reshape(-1)
            acc = torch.zeros((B * s, x.shape[1]), device=dev)
            row = {"shape": [list(x.shape), s],
                   "bound_us": 1e3 * chip_smoke.kernel_bound(
                       "seg_sum", (x, seg, s), {}, want, None)[0],
                   "index_add_": {
                       "events_us": 1e3 * events_ms(
                           lambda: acc.index_add_(0, idx, src), 200),
                       "device_us": device_us(
                           lambda: acc.index_add_(0, idx, src), 50,
                           r"^(?!.*pw_)")}}
            for name, fn in calls.items():
                row[name] = {"events_us": 1e3 * events_ms(fn, 200),
                             "device_us": device_us(fn, 50, "pw_"),
                             "kernels": {k.split("(")[0]: t / 50 for t, _, k in
                                         kernel_rows_of(fn, 50)
                                         if "pw_" in k}}
            rows[label] = row
            print(f"[seg_sum] {label} R={x.shape[1]} S={s}: " + "; ".join(
                f"{name} {row[name]['device_us']:.2f} us device, "
                f"{row[name]['events_us']:.2f} by events"
                for name in [*calls, "index_add_"])
                + f"; bound {row['bound_us']:.2f} us; kernels " + str(
                    {name: {k: round(v, 2) for k, v in row[name][
                        "kernels"].items()} for name in calls}), flush=True)
        mm = first_calls(
            split_gen, PatchworkConfig(), seg_cuda, "seg_minmax",
            lambda a: f"C={a[0].shape[1]}" if a[3] > 81 else None)
        mm.update({"C=3 level 0": a for a in first_calls(
            split_gen, PatchworkConfig(), seg_cuda, "seg_minmax",
            lambda a: "C=3 level 0" if a[3] == 81 else None).values()})
        for label, (v, seg, mask, s) in mm.items():
            label = f"generic split B={B} N={N_GEN} {label}"
            want = seg_cuda.seg_minmax_plain(v, seg, mask, s)
            calls = {"call": lambda: seg_cuda.seg_minmax(v, seg, mask, s)}
            for name, fn in calls.items():
                check(all(bits(g, w) for g, w in zip(fn(), want))
                      and all(bits(g, w) for g, w in zip(fn(), want)),
                      f"seg_minmax {label} {name} vs plain, twice")
            row = {"shape": [list(v.shape), s],
                   "bound_us": 1e3 * chip_smoke.kernel_bound(
                       "seg_minmax", (v, seg, mask, s), {}, want, None)[0]}
            for name, fn in calls.items():
                row[name] = {"events_us": 1e3 * events_ms(fn, 200),
                             "device_us": device_us(fn, 50, "pw_")}
            rows[label] = row
            print(f"[seg_minmax] {label} S={s}: " + "; ".join(
                f"{name} {row[name]['device_us']:.2f} us device, "
                f"{row[name]['events_us']:.2f} by events" for name in calls)
                + f"; bound {row['bound_us']:.2f} us", flush=True)
        out["seg"] = rows

    def kernel_rows_of(fn, reps):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return kernel_rows(prof)

    if "seg" in sections:
        seg_section()

    # ---- one profiled batch per path: device busy, span, idle share ----
    def profile_batch(label, fn):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span = (time.perf_counter() - t0) * 1e3
        rows = sorted(((t / 1e3, c, k) for t, c, k in kernel_rows(prof)),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{k[:40]} {t:.2f} ms x{c}" for t, c, k in rows[:5])
        out.setdefault("profiles", {})[label] = {
            "busy_ms": busy, "span_ms": span, "idle": 1 - busy / span,
            "top": [(k, t, c) for t, c, k in rows[:8]]}
        print(f"[profile] {label}: device busy {busy:.2f} ms of a "
              f"{span:.2f} ms span, idle share {1 - busy / span:.3f}; {top}",
              flush=True)

    class _FirstLevel(Exception):
        pass

    def prologue(data, cfg):
        """Everything before the level path's first level launch: binning,
        the fast shift, tau and z_th, level 0's pack and tables."""
        def stop(*a, **kw):
            raise _FirstLevel

        saved, engine.level = engine.level, stop
        try:
            filter_ground_batched(*data, cfg)
        except _FirstLevel:
            pass
        finally:
            engine.level = saved

    def host_section(data):
        """The generic path's host side on split terrain (B=8 x 153600):
        host time per ``fit_level`` call (50 unsynchronised calls) and of
        its scratch alone, and the functions that take the host's time in
        five batches under cProfile (wall time a batch with the profiler
        on)."""
        import cProfile
        import pstats

        cfg = PatchworkConfig()
        (p, g0, num_segs, max_iter), kw = capture(data, cfg, fit_cuda,
                                                  "fit_level")
        sp = fit_cuda.sp_width(num_segs)
        host = {"fit_level_us": host_us(lambda: fit_cuda.fit_level(
                    p, g0, num_segs, max_iter, **kw), 50),
                "fit_scratch_us": host_us(lambda: fit_cuda._fit_scratch(
                    p, sp, None), 2000)}
        filter_ground_batched(*data, cfg)
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(5):
            filter_ground_batched(*data, cfg)
        torch.cuda.synchronize()
        prof.disable()
        host["batch_ms_profiled"] = (time.perf_counter() - t0) / 5 * 1e3
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        host["top_ms_a_batch"] = {
            f"{os.path.basename(f)}:{line}({fn})": [tt / 5 * 1e3, ct / 5 * 1e3,
                                                    nc / 5]
            for (f, line, fn), (_, nc, tt, ct, _) in top}
        print(f"[host] split B={B} N={N_GEN} exact, generic path: fit_level "
              f"{host['fit_level_us']:.1f} us a call on the host, its scratch"
              f" {host['fit_scratch_us']:.1f} us; a batch "
              f"{host['batch_ms_profiled']:.2f} ms under cProfile", flush=True)
        for name, (tt, ct, nc) in host["top_ms_a_batch"].items():
            print(f"[host]   {tt:.3f} ms own, {ct:.3f} ms with callees, "
                  f"{nc:.0f} calls a batch: {name}", flush=True)
        out["host_generic"] = host

    velo = scenes["velodyne"]
    for fast in (False, True) if "profiles" in sections else ():
        cfg = PatchworkConfig(fast_covariance=fast)
        mode = "fast" if fast else "exact"
        profile_batch(f"velodyne B={B} N={N} {mode}, binning",
                      lambda: binning.assign_patches(*velo, cfg))
        profile_batch(f"velodyne B={B} N={N} {mode}, level-0 prologue",
                      lambda: prologue(velo, cfg))
        profile_batch(f"velodyne B={B} N={N} {mode}, level path",
                      lambda: filter_ground_batched(*velo, cfg))
        profile_batch(f"velodyne128 B={B} N={N_GEN} {mode}, generic path",
                      lambda: filter_ground_batched(*gen, cfg))
        profile_batch(f"velodyne128 B={B} N={N_GEN} {mode}, level path forced",
                      lambda: chip_smoke.level_path(
                          engine, filter_ground_batched, *gen, cfg))
    if "profiles" in sections or "scans" in sections:
        big = batch(velodyne_like_cloud, B, chip_smoke.N_BIG, num_beams=128)
        split_gen = batch(split_terrain_cloud, B, N_GEN)
    if "profiles" in sections:
        profile_batch(f"velodyne128 B={B} N={chip_smoke.N_BIG} exact",
                      lambda: filter_ground_batched(*big, PatchworkConfig()))
        profile_batch(f"split B={B} N={N} exact, level path",
                      lambda: filter_ground_batched(*scenes["split"],
                                                    PatchworkConfig()))
        profile_batch(f"split B={B} N={N_GEN} exact, generic path",
                      lambda: filter_ground_batched(*split_gen,
                                                    PatchworkConfig()))
    if "scans" in sections:
        rates = {}
        for fast in (False, True):
            cfg = PatchworkConfig(fast_covariance=fast)
            mode = "fast" if fast else "exact"
            rates[f"velodyne N={N} {mode}"] = chip_smoke.scans_per_s(
                *velo, cfg, False, 10)
            rates[f"velodyne128 N={N_GEN} {mode}, generic path"] = \
                chip_smoke.scans_per_s(*gen, cfg, False, 10)
            rates[f"velodyne128 N={N_GEN} {mode}, level path forced"] = \
                chip_smoke.level_path(engine, chip_smoke.scans_per_s, *gen,
                                      cfg, False, 10)
        rates[f"velodyne128 N={chip_smoke.N_BIG} exact"] = \
            chip_smoke.scans_per_s(*big, PatchworkConfig(), False, 10)
        rates[f"split N={N} exact"] = chip_smoke.scans_per_s(
            *scenes["split"], PatchworkConfig(), False, 10)
        rates[f"split N={N_GEN} exact, generic path"] = chip_smoke.scans_per_s(
            *split_gen, PatchworkConfig(), False, 10)
        for label, rate in rates.items():
            print(f"[scans] {label} B={B}: {rate:.1f} scans/s", flush=True)
        out["scans_per_s"] = rates

    if "host" in sections:
        host_section(batch(split_terrain_cloud, B, N_GEN))

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print("torch_kernel_bench: " + ("FAILED: " + "; ".join(bad) if bad
                                    else "all checks passed"), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
