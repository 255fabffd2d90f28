"""The port's multi-process execution on the card: the free segment
functions (kernels #6 and #8) and #2's per-round entry against their plain
versions, ``ordered_sum`` across two ranks on one card, the sharded entry
points over a one-rank NCCL group, and tools/torch_multihost_bench.py with
two ranks on one card.

These tests need an NVIDIA GPU and skip without one; they import no JAX:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
from patchwork_tpu_torch.io.synthetic import velodyne_like_cloud
from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda
from patchwork_tpu_torch.segment import segops

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import rounds_in_parts  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from patchwork_tpu_torch.core.device import cuda_device

    return cuda_device()


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, -0.0 != +0.0 and NaN payloads included."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("n,c", [(1000, 0), (131072, 3), (70001, 11)])
def test_free_seg_functions_on_card(dev, n, c):
    rng = np.random.default_rng(n)
    data = torch.from_numpy(rng.normal(0, 10, (n, c) if c else (n,)).astype(
        np.float32))
    seg = torch.from_numpy(rng.integers(0, 79, n).astype(np.int32))
    rows = data.reshape(n, -1).T.contiguous()[None].to(dev)
    ids = seg[None].to(dev)
    before = dict(fit_cuda.LAUNCHES)
    got = segops.seg_sum(data.to(dev), seg.to(dev), 81)
    lo = segops.seg_min(data.to(dev), seg.to(dev), 81)
    hi = segops.seg_max(data.to(dev), seg.to(dev), 81)
    assert fit_cuda.LAUNCHES["seg_sum"] - before["seg_sum"] == -(-max(c, 1)
                                                                  // 8)
    assert fit_cuda.LAUNCHES["seg_minmax"] - before["seg_minmax"] == 2
    plain = fit_cuda.seg_sum_plain(rows, ids, 81)[0].T.reshape(got.shape)
    mins, maxs = seg_cuda.seg_minmax_plain(
        rows, ids, torch.ones_like(ids, dtype=torch.bool), 81)
    assert _equal(got, plain)
    assert _equal(lo, mins[0].T.reshape(lo.shape))
    assert _equal(hi, maxs[0].T.reshape(hi.shape))
    # the CPU's free functions (the plain versions) give the same bits
    assert _equal(got.cpu(), segops.seg_sum(data, seg, 81))
    assert torch.isinf(lo[79:]).all() and (lo[79:] > 0).all()


@pytest.mark.parametrize("kind", ["normal", "ties", "extremes"])
def test_order_stat_rounds_on_card(dev, kind):
    """#2's per-round entry against its plain version, bit for bit, whole
    and in two halves; where k is in range, the one-launch kernel's value."""
    rng = np.random.default_rng(3)
    b, n, s = 2, 65536, 256
    vals = rng.normal(0, 10, (b, n)).astype(np.float32)
    if kind == "ties":
        vals = np.round(vals).astype(np.float32)
    elif kind == "extremes":
        vals[:, ::5] = 3e38
        vals[:, 1::5] = -3e38
        vals[:, 2::5] = -0.0
        vals[:, 3::7] = 1e-42
    seg = rng.integers(0, s - 3, (b, n)).astype(np.int32)
    seg[:, n // 2:][seg[:, n // 2:] == 7] = 8      # node 7 on one half only
    valid = rng.random((b, n)) < 0.95
    cnt = np.stack([np.bincount(seg[i][valid[i]], minlength=s)
                    for i in range(b)])
    k = np.where(cnt > 0, cnt // 2, -1).astype(np.int32)
    k[:, 5] = 0
    t = [torch.from_numpy(a).to(dev) for a in (vals, seg, valid, k)]
    before = fit_cuda.LAUNCHES["seg_order_stat_rounds"]
    got = fit_cuda.seg_order_stat(*t, s, reduce=lambda h: h)
    assert fit_cuda.LAUNCHES["seg_order_stat_rounds"] - before == 7
    want = fit_cuda.seg_order_stat_plain(*t, s, reduce=lambda h: h)
    assert _equal(got, want)
    assert _equal(got.cpu(), fit_cuda.seg_order_stat_plain(
        *(x.cpu() for x in t), s, reduce=lambda h: h))
    used = t[3] >= 0
    assert _equal(got[used], fit_cuda.seg_order_stat(*t, s)[used])
    halves = rounds_in_parts(fit_cuda.seg_order_stat, (*t, s), 2)
    plain = rounds_in_parts(fit_cuda.seg_order_stat_plain, (*t, s), 2)
    for h, p in zip(halves, plain):
        assert _equal(h, p) and _equal(h, got)


_RANK = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, {repo!r})
    from patchwork_tpu_torch.parallel import initialize_multihost
    from patchwork_tpu_torch.parallel.mesh import ordered_sum
    rank = int(sys.argv[1])
    torch.cuda.set_device(0)
    initialize_multihost("file://{store}", 2, rank, backend="gloo")
    gen = torch.Generator(device="cuda").manual_seed(rank)
    t = torch.randn((1000, 6), generator=gen, device="cuda") * 1e3
    s = ordered_sum(t, torch.distributed.group.WORLD)
    torch.save((t.cpu(), s.cpu()), "{out}" + str(rank))
    torch.distributed.destroy_process_group()
""")


def test_ordered_sum_same_bits_on_every_rank(dev, tmp_path):
    code = _RANK.format(repo=REPO, store=tmp_path / "store",
                        out=tmp_path / "rank")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)])
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    (t0, s0), (t1, s1) = (torch.load(tmp_path / f"rank{r}")
                          for r in range(2))
    assert _equal(s0, s1)
    assert _equal(s0, (t0.to(dev) + t1.to(dev)).cpu())


def test_one_rank_nccl_entry_points(dev, tmp_path):
    import torch.distributed as dist
    from patchwork_tpu_torch.parallel import (
        initialize_multihost, make_mesh, make_sharded_pipeline,
        make_shardmap_fused, make_shardmap_patchwork)
    from patchwork_tpu_torch.slam import BAProblem, bundle_adjust, \
        bundle_adjust_sharded

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_multihost_bench import synthetic_ba

    assert initialize_multihost(f"file://{tmp_path}/store", 1, 0,
                                backend="nccl")
    try:
        m = make_mesh()
        xyz = torch.from_numpy(np.stack([velodyne_like_cloud(16384, seed=i)
                                         for i in range(2)])).to(dev)
        valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        cfg = PatchworkConfig()
        want = filter_ground_batched(xyz, valid, cfg).ground
        assert torch.equal(make_shardmap_fused(cfg, m)(xyz, valid).ground,
                           want)
        res, g_cnt, _ = make_sharded_pipeline(cfg, m)(xyz, valid)
        assert torch.equal(res.ground, filter_ground_batched(
            xyz, valid, cfg.replace(segment_impl="pallas")).ground)
        assert torch.equal(g_cnt, res.ground.sum(1, dtype=torch.int32))
        cfg_pw = PatchworkConfig.patchwork()
        assert torch.equal(make_shardmap_patchwork(cfg_pw, m)(xyz, valid),
                           filter_ground_batched(xyz, valid, cfg_pw).ground)
        for solver, shape in (("dense", (12, 40, 480)),
                              ("pcg", (40, 60, 4000))):
            a = synthetic_ba(*shape)
            prob = BAProblem.from_numpy(*(a[k] for k in (
                "poses", "points", "obs_k", "obs_l", "obs_p", "obs_w")))
            s = bundle_adjust_sharded(prob, m, iters=2, solver=solver)
            o = bundle_adjust(prob, iters=2, solver=solver)
            assert _equal(s.poses, o.poses) and _equal(s.points, o.points)
    finally:
        dist.destroy_process_group()


def test_tool_two_ranks_on_one_card(dev, tmp_path):
    out = tmp_path / "mh.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "torch_multihost_bench.py"),
         "--procs", "2", "--device", "cuda", "--backend", "gloo", "--batch",
         "2", "--points", "16384", "--timeout", "240", "--json-out",
         str(out)], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-2000:]
    doc = json.loads(out.read_text())
    assert doc["all_ok"] and len(doc["workers"]) == 2
    for w in doc["workers"]:
        assert w["sp_impl"] == "pallas" and w["clock"] == "cuda events"
        assert w["launches"]["explicit"].get("seg_gather", 0) > 0
        assert w["launches"]["explicit"].get("seg_minmax", 0) > 0
        assert w["launches"]["dp"].get("level", 0) > 0
        assert w["peak_mb"]["sp"] > 0 and w["busy_ms"]["sp"] > 0
        assert w["sp_pct_bit_errors"] == 0
        assert w["launches"]["sp_pct"].get("seg_order_stat_rounds", 0) > 0
