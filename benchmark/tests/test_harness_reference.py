"""The frozen reference against the port's oracle: the same masks on small
scans of both scenes, under the node's parameters and the defaults."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmark import reference
from benchmark.traffic import organized, terrain, urban
from patchwork_tpu_torch import PatchworkConfig
from patchwork_tpu_torch.oracle.reference import filter_ground_oracle

NODE = dict(max_iter=50, th_dist=0.1, th_seeds=0.1)
SENSOR = {"beams": 64, "mount_height_m": 1.73, "max_range_m": 80.0}


def _scan(scene: str, n: int, seed: int) -> np.ndarray:
    if scene == "urban":
        return urban.scan(n, seed, SENSOR)
    if scene == "organized":
        cols = n // 32
        return organized.scan(32 * cols, seed, {
            **SENSOR, "beams": 32, "columns": cols,
            "vertical_fov_deg": [-22.5, 22.5]})
    return terrain.scan(n, seed, SENSOR)


@pytest.mark.parametrize("params", [NODE, {}], ids=["node", "defaults"])
@pytest.mark.parametrize("scene", ["urban", "terrain", "organized"])
@pytest.mark.parametrize("n,seed", [(3000, 0), (6000, 2**31 + 7),
                                    (12000, 41)])
def test_reference_matches_port_oracle(scene, n, seed, params):
    cfg = PatchworkConfig(**params)
    pts = _scan(scene, n, seed)
    got = reference.filter_ground(
        pts, reference.Algorithm.from_dict(dataclasses.asdict(cfg)))
    want = filter_ground_oracle(pts, cfg)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_reference_helpers_match_port():
    from patchwork_tpu_torch.ops.pointcloud import polar_angle
    from patchwork_tpu_torch.segment.binning import ring_edges, sector_edges
    import torch

    cfg = PatchworkConfig(**NODE)
    alg = reference.Algorithm.from_dict(dataclasses.asdict(cfg))
    np.testing.assert_array_equal(reference.ring_edges(alg), ring_edges(cfg))
    np.testing.assert_array_equal(reference.sector_edges(alg),
                                  sector_edges(cfg))
    xy = torch.from_numpy(_scan("urban", 5000, 3)[:, :2].copy())
    assert torch.equal(reference.polar_angle(xy), polar_angle(xy))


def test_fit_work_counts_the_recursion():
    alg = reference.Algorithm.from_dict(
        dataclasses.asdict(PatchworkConfig(**NODE)))
    flat, deep = reference.FitWork(), reference.FitWork()
    u = _scan("urban", 8000, 5)
    t = _scan("terrain", 8000, 5)
    masks = reference.filter_ground(u, alg, flat)
    reference.filter_ground(t, alg, deep)
    # counting changes no answer
    for a, b in zip(masks, reference.filter_ground(u, alg)):
        np.testing.assert_array_equal(a, b)
    assert flat.scans == deep.scans == 1
    assert flat.level_points == len(u)          # urban: level 0 only
    assert deep.level_points >= 3 * len(t)      # terrain recurses
    for w in (flat, deep):
        assert w.dist_points > 0 and w.fit_points > 0
        assert 0 < w.resid_points <= w.fit_points


@pytest.mark.parametrize("scene", ["urban", "terrain", "organized"])
def test_patch_ids_bin_as_filter_ground(scene):
    cfg = PatchworkConfig(**NODE)
    alg = reference.Algorithm.from_dict(dataclasses.asdict(cfg))
    pts = _scan(scene, 8000, 2**31 + 13)
    pts[:5] = np.nan
    ids = reference.patch_ids(pts, alg)
    _, _, _, in_patch = reference.filter_ground(pts, alg)
    np.testing.assert_array_equal(ids >= 0, in_patch)
    assert ids.max() < alg.num_rings * alg.num_sectors
    assert len(np.unique(ids[ids >= 0])) > alg.num_sectors
