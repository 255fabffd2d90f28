"""Sharded PCG bundle adjustment at the 1000-keyframe shape on the CPU: the
margin between W ranks and one process is the CPU's segment sums', in the
JAX package as in the port.

BA's CPU sums ("sort") take differences of one float32 prefix sum over all
observations, whose rounding grows with the prefix; a rank's prefix runs
over its own block only, so W ranks round otherwise than one process.  With
sums that add each segment from zero ("scatter", and kernel #6 on the
card) the margin is some 20 times smaller."""

import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_ba_bench  # noqa: E402
from torch_multihost_bench import synthetic_ba  # noqa: E402

W = 4
SHAPE = (1000, 339, 205991)   # tools/torch_multihost_bench.py's PCG problem


@pytest.fixture(scope="module")
def arrays():
    a = synthetic_ba(*SHAPE)
    pad = (-len(a["obs_k"])) % W
    for key in ("obs_k", "obs_l", "obs_p", "obs_w"):
        a[key] = np.concatenate([a[key], np.zeros((pad,) + a[key].shape[1:],
                                                  a[key].dtype)])
    return a


@pytest.mark.skipif(len(jax.devices()) < W, reason=f"needs {W} devices")
def test_sharded_pcg_margin_is_the_cpu_sums_in_both_packages(arrays):
    import jax.numpy as jnp

    from patchwork_tpu.parallel.mesh import make_mesh
    from patchwork_tpu.slam import ba as jba
    from patchwork_tpu_torch.slam.ba import BAProblem

    keys = torch_ba_bench.BA_KEYS
    jprob = jba.BAProblem(*(jnp.asarray(arrays[k]) for k in keys))
    one = np.asarray(jba.bundle_adjust(jprob, iters=2, solver="pcg").poses)
    sharded = np.asarray(jba.bundle_adjust_sharded(
        jprob, make_mesh(W, dp=W, sp=1), axis="dp", iters=2,
        solver="pcg").poses)
    jax_margin = float(np.abs(sharded - one).max())

    torch.set_num_threads(2)
    prob = BAProblem.from_numpy(*(arrays[k] for k in keys), device="cpu")
    poses = torch_ba_bench.rank_order_poses(prob, ["sort", "scatter"], [W], 2)
    port = {impl: float((poses[(impl, W)] - poses[(impl, 1)]).abs().max())
            for impl in ("sort", "scatter")}
    impls = float((poses[("sort", 1)] - poses[("scatter", 1)]).abs().max())
    print(f"W={W}: JAX {jax_margin:.3e}, port sort {port['sort']:.3e}, "
          f"port scatter {port['scatter']:.3e}, sort vs scatter in one "
          f"process {impls:.3e}")
    # the same order in both packages, under the same CPU sums
    assert 1e-4 < port["sort"] < 3 * jax_margin
    assert 1e-4 < jax_margin < 3 * port["sort"]
    # sums that add each segment from zero: a margin well inside 1e-4
    assert port["scatter"] < 1e-4 < impls
