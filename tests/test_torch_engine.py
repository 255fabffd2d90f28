"""The port's engine (plain versions on the CPU) against the recursive NumPy
oracle: exact-mode masks bit for bit on the parity scenes, as
tests/test_engine_parity.py holds the JAX engine."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.oracle.reference import filter_ground_oracle  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig, filter_ground  # noqa: E402
from patchwork_tpu_torch.io.synthetic import demo_point_cloud  # noqa: E402
from patchwork_tpu_torch.oracle import reference  # noqa: E402
from patchwork_tpu_torch.oracle.scenes import (  # noqa: E402
    DEFICIENT_CONFIG, DEFICIENT_IOU_MIN, PARITY_SCENES, all_deficient_scene)

torch.set_num_threads(1)


SCENES = PARITY_SCENES


def _run(pts, kw, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    return filter_ground(torch.from_numpy(pts), torch.from_numpy(valid),
                         PatchworkConfig(**kw))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_exact_masks_match_oracle(name):
    make, kw = SCENES[name]
    pts = make()
    g_o, v_o, z_o, p_o = filter_ground_oracle(pts, JaxConfig(**kw))
    res = _run(pts, kw)
    np.testing.assert_array_equal(res.valid.numpy(), v_o)
    np.testing.assert_array_equal(res.in_zone.numpy(), z_o)
    np.testing.assert_array_equal(res.in_patch.numpy(), p_o)
    np.testing.assert_array_equal(res.ground.numpy(), g_o)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_exact_masks_match_port_oracle(name):
    # the same scenes against the port's own NumPy oracle, which the card's
    # masks are held to where JAX is not installed
    make, kw = SCENES[name]
    pts = make()
    outs = reference.filter_ground_oracle(pts, PatchworkConfig(**kw))
    res = _run(pts, kw)
    for got, want in zip((res.ground, res.valid, res.in_zone, res.in_patch),
                         outs):
        np.testing.assert_array_equal(got.numpy(), want)


def test_all_deficient_iou():
    # every adaptive seed threshold lies below all points: 3-point seed
    # fits are ill-conditioned, so oracle parity is IoU-level (PARITY.md)
    pts = all_deficient_scene()
    kw = DEFICIENT_CONFIG
    g = _run(pts, kw).ground.numpy()
    for g_o in (filter_ground_oracle(pts, JaxConfig(**kw))[0],
                reference.filter_ground_oracle(pts, PatchworkConfig(**kw))[0]):
        assert (g & g_o).sum() / max((g | g_o).sum(), 1) > DEFICIENT_IOU_MIN


def test_validity_mask_padding():
    pts = demo_point_cloud(4000, seed=13)
    padded = np.concatenate([pts, np.full((512, 3), 1e9, np.float32)])
    valid = np.zeros(len(padded), bool)
    valid[:4000] = True
    kw = dict(filtering_radius=50.0)
    g = _run(padded, kw, valid).ground.numpy()
    g_o, *_ = filter_ground_oracle(pts, JaxConfig(**kw))
    np.testing.assert_array_equal(g[:4000], g_o)
    assert not g[4000:].any()
