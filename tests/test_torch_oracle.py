"""The port's NumPy oracle (patchwork_tpu_torch/oracle) against the JAX
package's, bit for bit in all four masks, and the port's debug_nans."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.oracle import reference as jax_reference  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig  # noqa: E402
from patchwork_tpu_torch.io.synthetic import (  # noqa: E402
    HARD_SCENES, hard_labeled_scene)
from patchwork_tpu_torch.oracle import reference  # noqa: E402
from patchwork_tpu_torch.oracle.scenes import (  # noqa: E402
    DEFICIENT_CONFIG, PARITY_SCENES, all_deficient_scene)
from patchwork_tpu_torch.utils.debug import debug_nans  # noqa: E402

torch.set_num_threads(1)

CASES = {f"parity/{k}": v for k, v in PARITY_SCENES.items()}
CASES["all_deficient"] = (all_deficient_scene, DEFICIENT_CONFIG)
for _name in HARD_SCENES:
    CASES[f"hard/{_name}"] = (
        lambda name=_name: hard_labeled_scene(name, 4096, seed=0)[0], {})


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_jax_oracle(case):
    make, kw = CASES[case]
    pts = make()
    got = reference.filter_ground_oracle(pts, PatchworkConfig(**kw))
    want = jax_reference.filter_ground_oracle(pts, JaxConfig(**kw))
    for name, a, b in zip(("ground", "valid", "in_zone", "in_patch"), got,
                          want):
        assert a.dtype == b.dtype == np.bool_
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_plane_fit_and_split_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, [8, 8, 0.3], (600, 3)).astype(np.float32)
    pts[:, 2] += 0.1 * pts[:, 0] + 0.6 * (pts[:, 1] > 0)
    for a, b in zip(reference.fit_plane_pca(pts),
                    jax_reference.fit_plane_pca(pts)):
        np.testing.assert_array_equal(a, b)
    for depth in (0, 1, 3):
        np.testing.assert_array_equal(
            reference.fit_plane_and_split(pts, 20.0, depth, PatchworkConfig()),
            jax_reference.fit_plane_and_split(pts, 20.0, depth, JaxConfig()))
    np.testing.assert_array_equal(reference.clean_mask(pts[:2]), [True, True])


def test_oracle_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys, patchwork_tpu_torch.oracle; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', "
            "'patchwork_tpu.')) or m == 'patchwork_tpu' for m in sys.modules)))")
    assert subprocess.run([sys.executable, "-c", code], cwd=_repo()).returncode == 0


def _repo():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- debug_nans ---------------------------------------------------------------

def test_debug_nans_raises_at_the_first_nan_and_names_the_call():
    x = torch.zeros(4)
    with pytest.raises(FloatingPointError, match=r"torch\.Tensor\.div"):
        with debug_nans():
            y = x + 1.0            # finite: passes
            _ = x / x              # 0/0: raises here
            y.log()                # never reached
    with pytest.raises(FloatingPointError, match=r"torch\.log"):
        with debug_nans():
            torch.log(-torch.ones(2))
    with pytest.raises(FloatingPointError, match="inf"):
        with debug_nans():
            torch.ones(3).div_(0.0)   # in place: the written tensor is checked


def test_debug_nans_is_silent_on_a_finite_function():
    def fn(p):
        c = p.mean(0)
        cov = (p - c).T @ (p - c) / (len(p) - 1)
        w, v = torch.linalg.eigh(cov)
        return torch.abs((p - c) @ v[:, 0]).sum() + w.sum()

    p = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 3))
                         .astype(np.float32))
    with debug_nans():
        out = fn(p)
    assert torch.equal(out, fn(p))


def test_debug_nans_off_costs_nothing():
    from torch.overrides import _get_current_function_mode_stack

    x = torch.zeros(2)
    with debug_nans(False):
        assert not _get_current_function_mode_stack()   # no mode entered
        assert torch.isnan(x / x).all()                 # nothing checked
    with debug_nans():
        with debug_nans(False):                         # pauses the check
            assert torch.isnan(x / x).all()
        with pytest.raises(FloatingPointError):
            x / x
    assert not _get_current_function_mode_stack()
