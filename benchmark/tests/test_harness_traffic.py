"""The frozen scene generators against the port's, and the general
generator's pool and arrivals."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import traffic
from benchmark.traffic import organized, terrain, urban
from patchwork_tpu_torch.io import synthetic


@pytest.mark.parametrize("n,seed,beams", [(4096, 0, 64), (5000, 2**31 + 3, 128),
                                          (131072, 17, 64)])
def test_urban_is_velodyne_like_cloud(n, seed, beams):
    got = urban.scan(n, seed, {"beams": beams, "mount_height_m": 1.73,
                               "max_range_m": 80.0})
    want = synthetic.velodyne_like_cloud(n, seed=seed, num_beams=beams)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(4096, 0), (7001, 2**31 + 9),
                                    (131072, 5)])
def test_terrain_is_split_terrain_cloud(n, seed):
    np.testing.assert_array_equal(terrain.scan(n, seed, {}),
                                  synthetic.split_terrain_cloud(n, seed))


OS1 = {"beams": 128, "columns": 2048, "vertical_fov_deg": [-22.5, 22.5],
       "mount_height_m": 1.73, "max_range_m": 80.0}


def test_organized_sweep_is_the_sensors_image():
    pts = organized.scan(128 * 2048, 2**31 + 5, OS1)
    assert pts.shape == (262144, 3) and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, organized.scan(262144, 2**31 + 5, OS1))
    img = pts.reshape(128, 2048, 3)
    ret = (img != 0).any(-1)
    # the sky is a non-return unless an obstacle stands in the ray
    up, down = ret[:64], ret[64:]
    assert 0.05 < up.mean() < 0.5 and down.mean() > 0.8
    assert 0.4 < ret.mean() < 0.7
    # nothing beyond the range but the range noise; nothing below the ground
    r = np.linalg.norm(pts[ret.reshape(-1)], axis=1)
    assert r.max() < 80.0 * 1.03 and pts[:, 2].min() > -1.73 - 0.12
    # rows are beam-major: one beam's returns sweep once in azimuth
    beam = img[100][ret[100]]
    az = np.unwrap(np.arctan2(beam[:, 1], beam[:, 0]))
    assert np.all(np.diff(az) > -0.05)
    with pytest.raises(ValueError):
        organized.scan(1000, 0, OS1)


def test_organized_sweeps_share_their_obstacles_across_seeds():
    a = organized.scan(16 * 256, 1, {**OS1, "beams": 16, "columns": 256})
    b = organized.scan(16 * 256, 2, {**OS1, "beams": 16, "columns": 256})
    assert not np.array_equal(a, b)
    counts = [int((organized.scan(262144, s, OS1) != 0).any(1).sum())
              for s in (3, 4, 2**31 + 6)]
    assert max(counts) / min(counts) < 1.3


def test_pool_sizes_same_work_for_every_seed():
    a = traffic.pool_sizes(110000, 130000, 32, 1)
    b = traffic.pool_sizes(110000, 130000, 32, 2**31 + 1)
    assert sorted(a) == sorted(b)
    assert a.min() == 110000 and a.max() == 130000
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, traffic.pool_sizes(110000, 130000, 32, 1))


def test_make_pool_is_drawn_from_the_seed():
    sensor = {"beams": 64, "mount_height_m": 1.73, "max_range_m": 80.0,
              "points_min": 1000, "points_max": 1500}
    mix = {"pool": 3, "scene_args": {"obstacle_fraction": 0.15}}
    a = traffic.make_pool(urban, sensor, mix, 2**31 + 11)
    b = traffic.make_pool(urban, sensor, mix, 2**31 + 11)
    c = traffic.make_pool(urban, sensor, mix, 2**31 + 12)
    assert [len(s) for s in a] == list(traffic.pool_sizes(1000, 1500, 3,
                                                          2**31 + 11))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0][:100], c[0][:100])


def test_closed_loop_stops_at_the_window_end():
    pool = [np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32)]
    src = traffic.ClosedLoop(pool, t_end=0.0)
    assert list(src) == [] and src.handed == []
    import time
    src = traffic.ClosedLoop(pool, time.perf_counter() + 0.05)
    got = list(src)
    assert len(got) == len(src.handed) > 2
    assert got[0] is pool[0] and got[1] is pool[1] and got[2] is pool[0]


def test_open_loop_hands_nothing_before_it_is_due(monkeypatch):
    import time
    pool = [np.zeros((1, 3), np.float32)]
    t0 = time.perf_counter() + 0.02
    src = traffic.OpenLoop(pool, t0, 0.01, 5)
    assert src.due == pytest.approx([t0 + 0.01 * k for k in range(5)])
    assert len(list(src)) == 5
    assert all(h >= d for h, d in zip(src.handed, src.due))
