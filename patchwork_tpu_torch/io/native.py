"""ctypes bindings for the native host I/O library.

Counterpart of ``patchwork_tpu/io/native.py``.  The source is the
repository's ``native/patchwork_native.cpp``, read in place; ``g++`` builds
it on first use into ``build/`` at the repository root (listed in
.gitignore), named by a hash of the source and flags, so the JAX package's
own build in its package directory is never touched.  Every entry point
has a NumPy fallback for a machine without a compiler; this is host code,
not a device kernel.  ``native_available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "native_available",
    "extract_xyz",
    "load_kitti_bin_padded",
    "voxel_downsample_host",
    "NativeAssociator",
]

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "patchwork_native.cpp"
_BUILD = _ROOT / "build"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[pathlib.Path]:
    """The built library, compiling it if needed; None without a source or
    a compiler."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    so = _BUILD / f"patchwork_native_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    tmp = so.with_suffix(f".{os.getpid()}.so")
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: concurrent processes race harmlessly
    except (OSError, subprocess.SubprocessError):
        return None
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so_path = _build()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError:
            return None
        lib.pw_extract_xyz.restype = ctypes.c_int64
        lib.pw_extract_xyz.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.pw_load_kitti_bin.restype = ctypes.c_int64
        lib.pw_load_kitti_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pw_voxel_downsample.restype = ctypes.c_int64
        lib.pw_voxel_downsample.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.pw_assoc_create.restype = ctypes.c_void_p
        lib.pw_assoc_create.argtypes = [ctypes.c_double]
        lib.pw_assoc_destroy.argtypes = [ctypes.c_void_p]
        lib.pw_assoc_size.restype = ctypes.c_int64
        lib.pw_assoc_size.argtypes = [ctypes.c_void_p]
        lib.pw_assoc_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pw_assoc_export.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def extract_xyz(
    data: np.ndarray, point_step: int, off_x: int, off_y: int, off_z: int
) -> np.ndarray:
    """Strided xyz extraction from packed point records ((n*step,) uint8)."""
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data) // point_step
    lib = _load()
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        lib.pw_extract_xyz(
            data.ctypes.data, n, point_step, off_x, off_y, off_z,
            out.ctypes.data,
        )
        return out
    rec = data[: n * point_step].reshape(n, point_step)
    return np.stack(
        [rec[:, o : o + 4].copy().view(np.float32)[:, 0] for o in (off_x, off_y, off_z)],
        axis=1,
    )


def load_kitti_bin_padded(path: str, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass KITTI .bin load into a fixed (capacity, 3) buffer +
    finite-validity mask."""
    lib = _load()
    if lib is not None:
        xyz = np.zeros((capacity, 3), np.float32)
        valid = np.zeros(capacity, np.uint8)
        n = lib.pw_load_kitti_bin(
            path.encode(), xyz.ctypes.data, valid.ctypes.data, capacity
        )
        if n < 0:
            raise IOError(f"cannot read {path}")
        return xyz, valid.astype(bool)
    from .kitti import read_bin

    pts = read_bin(path)
    n = min(len(pts), capacity)
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = pts[:n]
    valid = np.zeros(capacity, bool)
    valid[:n] = np.isfinite(pts[:n]).all(axis=1)
    return xyz, valid


class NativeAssociator:
    """Greedy sequential landmark association in C++ (the SLAM back end's,
    patchwork_tpu/slam/landmarks.py): strict-gate nearest over running
    means, intra-keyframe visibility, running-mean re-bucketing.  Raises
    RuntimeError when the native library is unavailable.
    """

    def __init__(self, gate: float):
        lib = _load()
        if lib is None:
            raise RuntimeError("native associator unavailable")
        self._lib = lib
        self._h = lib.pw_assoc_create(float(gate))

    def __del__(self):  # pragma: no cover - interpreter teardown
        h = getattr(self, "_h", None)
        if h:
            self._lib.pw_assoc_destroy(h)
            self._h = None

    @property
    def n(self) -> int:
        return int(self._lib.pw_assoc_size(self._h))

    def associate(self, world: np.ndarray) -> np.ndarray:
        world = np.ascontiguousarray(world, np.float32)
        ids = np.empty(len(world), np.int64)
        self._lib.pw_assoc_add(
            self._h, world.ctypes.data, len(world), ids.ctypes.data)
        return ids

    def export(self):
        """(pos (L, 3) float32 running means, counts (L,) int64)."""
        n = self.n
        pos = np.empty((n, 3), np.float32)
        cnt = np.empty(n, np.int64)
        if n:
            self._lib.pw_assoc_export(
                self._h, pos.ctypes.data, cnt.ctypes.data)
        return pos, cnt


def voxel_downsample_host(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host-side voxel-grid centroid filter (ingest decimation).

    Native open-addressing hash when built; NumPy lexsort fallback.
    Device-side equivalent: ops.sampling.voxel_grid_filter.
    """
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    if n == 0 or voxel_size <= 0:
        return xyz.copy()
    lib = _load()
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        m = lib.pw_voxel_downsample(xyz.ctypes.data, n, voxel_size, out.ctypes.data)
        return out[:m].copy()
    vox = np.floor(xyz / voxel_size).astype(np.int64)
    order = np.lexsort((vox[:, 2], vox[:, 1], vox[:, 0]))
    sv = vox[order]
    sx = xyz[order]
    first = np.concatenate([[True], (sv[1:] != sv[:-1]).any(axis=1)])
    run = np.cumsum(first) - 1
    cnt = np.bincount(run)
    sums = np.zeros((len(cnt), 3), np.float64)
    np.add.at(sums, run, sx)
    return (sums / cnt[:, None]).astype(np.float32)
