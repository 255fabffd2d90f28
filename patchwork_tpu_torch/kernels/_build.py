"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources are ``patchwork_tpu_torch/csrc/*.cu``: plain C entry points
(no PyTorch headers).  ``nvcc`` compiles each source for ``sm_90a`` into an
object file, one process per source, all started together, and then links
them into one shared library under ``build/`` at the repository root
(listed in .gitignore).
Each C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()``.

``-fmad=false`` keeps every ``a * b + c`` as a rounded multiply and a
rounded add, the arithmetic PyTorch's separate elementwise ops perform, so
a kernel and its plain version compute the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

__all__ = ["load", "build_seconds", "ptxas_info", "CSRC"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD = CSRC.parent.parent / "build"

_lib = None
_build_seconds = None

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argument types (pointers and the stream are void*)
_SIGNATURES = {
    "pw_seg_order_stat": [_VP] * 9 + [_I, _I, _I, _VP],
    "pw_os_prepare": [_VP] * 7 + [_I, _I, _I, _VP],
    "pw_os_round_launch": [_VP] * 8 + [_I] * 4 + [_VP],
    "pw_os_final_launch": [_VP] * 4 + [_I, _VP],
    "pw_seg_sum": [_VP] * 5 + [_I] * 4 + [_VP],
    "pw_seg_sum_planned": [_VP] * 10 + [_I] * 5 + [_VP],
    "pw_sweep_plan": [_VP] * 8 + [_I] * 6 + [_VP],
    "pw_seg_plan": [_VP] * 8 + [_I] * 4 + [_VP],
    "pw_apply_sweep": [_VP] * 12 + [_I] * 6 + [_VP],
    "pw_moments2_sweep": [_VP] * 12 + [_I] * 5 + [_VP],
    "pw_remap_r1": [_VP] * 4 + [_I] * 5 + [_VP],
    "pw_remap_r1b": [_VP] * 5 + [_I] * 4 + [_VP],
    "pw_remap_nodes": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "pw_remap_points": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pw_node_stats": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pw_early_outs": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _I, _I,
                      _VP],
    "pw_deficient_round": [_VP] * 5 + [_I] * 4 + [_VP],
    "pw_seed_init": [_VP] * 12 + [_I] * 6 + [_VP],
    "pw_plane_table": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pw_split_decision": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "pw_finish_nodes": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pw_seg_gather": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pw_seg_minmax": [_VP] * 6 + [_I] * 4 + [_VP],
    "pw_run_sum": [_VP] * 6 + [_I, _I, _VP],
    "pw_fit_level": [_VP] * 16 + [_I] * 8 + [_VP],
    "pw_level_core": [_VP] * 26 + [_I] * 12 + [_F, _F, _VP],
    "pw_fit_level_blocks": [_I, _I, _I, _I, _I],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _compile(so: pathlib.Path, cu: list) -> None:
    """nvcc -c every source in parallel, then link them into ``so``."""
    nvcc = _nvcc()
    tmp = _BUILD / f"{so.stem}.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{p.stem}.o" for p in cu]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [pr.communicate()[0] for pr in procs]
    link = [nvcc, "-shared", "-o", str(tmp / so.name), *map(str, objs)]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    failed = [(c[-1], pr.returncode, o) for c, pr, o in zip(cmds, procs, outs)
              if pr.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(("link", res.returncode, res.stderr))
    (_BUILD / "nvcc.log").write_text("\n".join(log))
    if failed:
        src, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed on {src} ({rc}):\n{out[-4000:]}")
    os.replace(tmp / so.name, so)
    shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / f"libpatchwork_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        _compile(so, [p for p in srcs if p.suffix == ".cu"])
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def build_seconds():
    """Seconds the first :func:`load` took (build included), or None."""
    return _build_seconds


def ptxas_info(pattern: str = "") -> dict:
    """What ptxas reported (``-Xptxas -v``) when the library was built, for
    each kernel whose mangled name matches ``pattern``: registers a thread,
    spill stores and loads and stack frame in bytes.  Empty where the
    library came from an earlier build of the same sources."""
    log = _BUILD / "nvcc.log"
    if not log.exists():
        return {}
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used "
            r"(\d+) registers", log.read_text(), re.S):
        if re.search(pattern, m.group(1)):
            out[m.group(1)] = {"registers": int(m.group(5)),
                               "spill_stores": int(m.group(3)),
                               "spill_loads": int(m.group(4)),
                               "stack": int(m.group(2))}
    return out
