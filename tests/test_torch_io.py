"""The port's host I/O (bags, KITTI, native bindings, mask checkpoints)
against the JAX package's, on the CPU."""

import os
import sqlite3

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu.io import bag as jbag  # noqa: E402
from patchwork_tpu.io import kitti as jkitti  # noqa: E402
from patchwork_tpu.io import native as jnat  # noqa: E402
from patchwork_tpu.utils import checkpoint as jckpt  # noqa: E402
from patchwork_tpu_torch.io import bag as tbag  # noqa: E402
from patchwork_tpu_torch.io import kitti as tkitti  # noqa: E402
from patchwork_tpu_torch.io import native as tnat  # noqa: E402
from patchwork_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

torch.set_num_threads(1)


def _clouds(seed=0, sizes=(100, 2500, 0, 700)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 20, (n, 3)).astype(np.float32) for n in sizes]


def _read_all(reader_cls, path):
    with reader_cls(path) as r:
        return {t: list(r.iter_point_clouds(t)) for t in r.topic_names()}


def _assert_same(a, b):
    assert list(a) == list(b)
    for t in a:
        assert len(a[t]) == len(b[t])
        for x, y in zip(a[t], b[t]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compression", ["zstd", "none"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mcap_across_packages(tmp_path, writer, compression):
    if compression == "zstd":
        pytest.importorskip("zstandard")
    clouds = _clouds()
    path = str(tmp_path / "a.mcap")
    write = jbag.write_mcap if writer == "jax" else tbag.write_mcap
    write(path, clouds, compression=compression, chunk_size=8000)
    got, want = _read_all(tbag.BagReader, path), _read_all(jbag.BagReader, path)
    _assert_same(got, want)
    for x, y in zip(got["/lidar/points"], clouds):
        np.testing.assert_array_equal(x, y)
    with tbag.BagReader(path) as r:
        assert r.format == "mcap" and r.message_count("/lidar/points") == 4
        np.testing.assert_array_equal(r.load_point_cloud("/lidar/points", 1),
                                      clouds[1])


def test_mcap_writers_write_the_same_bytes(tmp_path):
    clouds = _clouds(1)
    a, b = str(tmp_path / "a.mcap"), str(tmp_path / "b.mcap")
    jbag.write_mcap(a, clouds, compression="none", chunk_size=5000)
    tbag.write_mcap(b, clouds, compression="none", chunk_size=5000)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_multi_topic_mcap_reads_in_both_packages(tmp_path):
    topics = {"/lidar_front": _clouds(2, (50, 60)),
              "/lidar_left": _clouds(3, (70, 0, 90)),
              "/imu": _clouds(4, (5,))}
    path = str(tmp_path / "m.mcap")
    tbag.write_mcap_topics(path, topics, compression="none", chunk_size=2000)
    got, want = _read_all(tbag.BagReader, path), _read_all(jbag.BagReader, path)
    _assert_same(got, want)
    _assert_same(got, topics)
    with jbag.BagReader(path) as r:
        assert r.point_cloud_topics() == ["/lidar_front", "/lidar_left"]
        assert [r.message_count(t) for t in topics] == [2, 3, 1]
        frames = r.load_multiple_point_clouds(["/lidar_front", "/lidar_left"], 1)
    np.testing.assert_array_equal(frames[1], topics["/lidar_left"][1])


def _make_db3(path, clouds, topic="/lidar/points"):
    # the rosbag2 schema, as tests/test_bag_native_node.py builds it
    conn = sqlite3.connect(path)
    conn.executescript(
        """
        CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,
                            serialization_format TEXT, offered_qos_profiles TEXT);
        CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,
                              timestamp INTEGER, data BLOB);
        """)
    conn.execute("INSERT INTO topics VALUES (1, ?, 'sensor_msgs/msg/PointCloud2',"
                 " 'cdr', '')", (topic,))
    for i, c in enumerate(clouds):
        conn.execute("INSERT INTO messages VALUES (?, 1, ?, ?)",
                     (i + 1, 1000 + i, jbag.encode_pointcloud2_cdr(c)))
    conn.commit()
    conn.close()


def test_db3_reads_the_same(tmp_path):
    clouds = _clouds(5)
    path = str(tmp_path / "a.db3")
    _make_db3(path, clouds)
    assert tbag.is_db3_format(path) and tbag.sniff_format(path) == "db3"
    got, want = _read_all(tbag.BagReader, path), _read_all(jbag.BagReader, path)
    _assert_same(got, want)
    with tbag.BagReader(path) as r:
        assert r.message_count("/lidar/points") == len(clouds)


@pytest.mark.parametrize("intensity", [False, True])
def test_cdr_codec_matches(intensity):
    pts = np.random.default_rng(6).normal(size=(333, 4)).astype(np.float32)
    blob = tbag.encode_pointcloud2_cdr(pts, "velo", with_intensity=intensity)
    assert blob == jbag.encode_pointcloud2_cdr(pts, "velo",
                                               with_intensity=intensity)
    fields = ("x", "y", "z", "intensity") if intensity else ("x", "y", "z")
    np.testing.assert_array_equal(tbag.decode_pointcloud2_cdr(blob, fields),
                                  jbag.decode_pointcloud2_cdr(blob, fields))


def _write_kitti(directory, n_frames=3):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n_frames):
        arr = rng.normal(0, 10, (500 + 100 * i, 4)).astype(np.float32)
        arr[::50, 1] = np.nan
        arr.tofile(os.path.join(directory, f"{i:06d}.bin"))
    return directory


def test_kitti_read_and_pad(tmp_path):
    d = _write_kitti(str(tmp_path / "velo"))
    assert tkitti.list_sequence(d) == jkitti.list_sequence(d)
    for a, b in zip(tkitti.iter_sequence(d, limit=2, with_intensity=True),
                    jkitti.iter_sequence(d, limit=2, with_intensity=True)):
        np.testing.assert_array_equal(a, b)
    pts = tkitti.read_bin(tkitti.list_sequence(d)[2])
    np.testing.assert_array_equal(pts, jkitti.read_bin(jkitti.list_sequence(d)[2]))
    for cap in (256, 1024):
        for a, b in zip(tkitti.pad_to_capacity(pts, cap),
                        jkitti.pad_to_capacity(pts, cap)):
            np.testing.assert_array_equal(a, b)


def test_native_entry_points_match(tmp_path):
    assert tnat.native_available() == jnat.native_available()
    rng = np.random.default_rng(8)
    rec = rng.normal(size=(400, 5)).astype(np.float32)   # point_step 20
    data = rec.view(np.uint8).reshape(-1)
    np.testing.assert_array_equal(tnat.extract_xyz(data, 20, 4, 8, 12),
                                  jnat.extract_xyz(data, 20, 4, 8, 12))
    d = _write_kitti(str(tmp_path / "velo"), 1)
    path = tkitti.list_sequence(d)[0]
    for cap in (300, 2048):
        for a, b in zip(tnat.load_kitti_bin_padded(path, cap),
                        jnat.load_kitti_bin_padded(path, cap)):
            np.testing.assert_array_equal(a, b)
    xyz = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tnat.voxel_downsample_host(xyz, 0.5),
                                  jnat.voxel_downsample_host(xyz, 0.5))


def test_native_associator_matches():
    if not tnat.native_available():
        with pytest.raises(RuntimeError):
            tnat.NativeAssociator(0.5)
        return
    rng = np.random.default_rng(9)
    a, b = tnat.NativeAssociator(0.8), jnat.NativeAssociator(0.8)
    for _ in range(3):
        world = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
        np.testing.assert_array_equal(a.associate(world), b.associate(world))
    assert a.n == b.n
    for x, y in zip(a.export(), b.export()):
        np.testing.assert_array_equal(x, y)


def test_native_library_builds_outside_the_jax_package():
    if tnat._load() is None:
        pytest.skip("no C++ compiler: the NumPy fallback is in use")
    lib = tnat._build()
    assert lib.parent == tnat._BUILD and "patchwork_tpu" not in lib.parent.parts


def test_save_load_masks_round_trip(tmp_path):
    rng = np.random.default_rng(10)
    ground = rng.random((4, 1001)) > 0.5
    valid = rng.random((4, 1001)) > 0.1
    ids = np.array([3, 5, 8, 13])
    path = str(tmp_path / "m.npz")
    tckpt.save_masks(path, ground, valid, ids)
    for load in (tckpt.load_masks, jckpt.load_masks):
        g, v, f = load(path)
        np.testing.assert_array_equal(g, ground)
        np.testing.assert_array_equal(v, valid)
        np.testing.assert_array_equal(f, ids)
    jpath = str(tmp_path / "j.npz")
    jckpt.save_masks(jpath, ground, valid)
    g, v, f = tckpt.load_masks(jpath)
    np.testing.assert_array_equal(g, ground)
    np.testing.assert_array_equal(f, np.arange(4))
