"""Finite-value checks.

Counterpart of ``patchwork_tpu/utils/debug.py``'s ``assert_finite``.  Its
``debug_nans`` (raise at the first op that makes a NaN) has no faithful
PyTorch counterpart for forward code and is not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from ..core.types import tensor_leaves

__all__ = ["assert_finite"]


def assert_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError if a floating tensor of the nested
    structure ``tree`` holds a NaN or an infinity."""
    for i, leaf in enumerate(tensor_leaves(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(
                f"{name}: leaf {i} contains {int(torch.isnan(leaf).sum())} "
                f"NaN / {int(torch.isinf(leaf).sum())} inf values")
