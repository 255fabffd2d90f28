"""Debug toggles and finite-value checks.

Counterpart of ``patchwork_tpu/utils/debug.py``.  The reference's
error-handling story is cudaGetLastError prints after every kernel
(cuda/cuda_wrapper.cu:119-123); here a failed launch raises
(``kernels/fit_cuda._launch``).  What remains useful is NaN tracing —
finding which op first produced a NaN — which :func:`debug_nans` gives as
JAX's ``jax_debug_nans`` does.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode, resolve_name

from ..core.types import tensor_leaves

__all__ = ["debug_nans", "assert_finite"]

_ON = [False]     # whether checks run; debug_nans(False) inside a check pauses it


def _name(func) -> str:
    return resolve_name(func) or getattr(func, "__qualname__", repr(func))


def _check(name: str, tree) -> None:
    for t in tensor_leaves(tree):
        if ((t.is_floating_point() or t.is_complex()) and t.numel()
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"debug_nans: {name} produced "
                f"{int(torch.isnan(t).sum())} NaN / "
                f"{int(torch.isinf(t).sum())} inf values "
                f"(shape {tuple(t.shape)})")


class _NanCheck(TorchFunctionMode):
    """Checks the floating outputs of every torch call made under it (the
    tensor written by an in-place method or ``__setitem__`` too).  Torch
    disables the mode inside this method, so the check's own calls are not
    checked."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _ON[0]:
            name = _name(func)
            _check(name, out)
            short = name.rsplit(".", 1)[-1]
            if args and (short == "__setitem__" or short.endswith("_")
                         and not short.startswith("_")
                         or short.startswith("__i")):
                _check(name, args[0])
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Context manager: raise ``FloatingPointError`` at the first torch call
    whose floating output holds a NaN or an infinity, naming the call.

    A ``torch.overrides.TorchFunctionMode`` checks every torch function and
    tensor method called under it, on the CPU and on the card (each check
    reads the device: use it for debugging only).  ``enabled=False``
    pauses an enclosing check, and costs nothing otherwise: no mode is
    entered.

    Not seen: the hand-written kernels, which ``kernels/fit_cuda._launch``
    calls through ctypes and are no torch calls; a NaN one of them writes
    shows at the first torch call that passes it on.

    Like JAX's, it raises on every NaN and infinity, the ones the engine
    makes on purpose too: non-finite input points, a node that holds no
    point (0/0 in a zero-table sweep, ROADMAP queue 2 C), the identities of
    masked reductions.  So it is an aid for finite inputs and for code
    outside those reductions.  On the CPU, ``filter_ground`` on a finite
    demo or velodyne-like cloud of 4096 points trips it at its first
    masked min: ``torch.full_like``, the +inf identity that
    ``segment/segops.SegOps._reduce`` fills in for points outside the mask
    (empty segments keep it, and the engine reads them as empty).
    """
    prev = _ON[0]
    _ON[0] = enabled
    try:
        if enabled and not prev:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _ON[0] = prev


def assert_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError if a floating tensor of the nested
    structure ``tree`` holds a NaN or an infinity."""
    for i, leaf in enumerate(tensor_leaves(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(
                f"{name}: leaf {i} contains {int(torch.isnan(leaf).sum())} "
                f"NaN / {int(torch.isinf(leaf).sum())} inf values")
