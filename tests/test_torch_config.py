"""The port's config against the JAX reference's, field for field."""

import pytest

jax = pytest.importorskip("jax")

from patchwork_tpu.core import config as jcfg  # noqa: E402
from patchwork_tpu_torch.core import config as tcfg  # noqa: E402

VARIANTS = [None] + list(tcfg.PatchworkConfig.VARIANTS)


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v or "default")
def test_to_json_equal(variant):
    if variant is None:
        t, j = tcfg.PatchworkConfig(), jcfg.PatchworkConfig()
    else:
        t = tcfg.PatchworkConfig.variant(variant)
        j = jcfg.PatchworkConfig.variant(variant)
    assert t.to_json() == j.to_json()
    assert (t.num_patches, t.max_active_nodes, t.effective_levels) == (
        j.num_patches, j.max_active_nodes, j.effective_levels)


def test_reference_config_converts_to_an_equal_port_config():
    j = jcfg.PatchworkConfig(num_sectors=16, max_iter=30,
                             adaptive_seed_height=False, th_dist=0.25,
                             max_levels=4, max_active_nodes_cfg=64,
                             fast_covariance=True)
    t = tcfg.PatchworkConfig.from_json(j.to_json())
    assert t.to_json() == j.to_json()
    assert t == tcfg.PatchworkConfig(**{f: getattr(j, f) for f in
                                        j.__dataclass_fields__})
    assert t.replace(num_rings=4).num_patches == 4 * 16


def test_lidar_configs_equal():
    assert [vars(c) for c in tcfg.default_lidar_configs()] == [
        vars(c) for c in jcfg.default_lidar_configs()]


@pytest.mark.parametrize("bad", [dict(num_rings=0), dict(max_levels=0),
                                 dict(r_min=200.0)])
def test_validation(bad):
    with pytest.raises(ValueError):
        jcfg.PatchworkConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.PatchworkConfig(**bad)
