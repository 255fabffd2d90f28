"""The CUDA device, the fp32 pins, and the card's identity.

Counterpart of ``patchwork_tpu/core/device.py``.  Unlike the reference's
CudaManager (cuda/cuda_interface.cu:44-95) nothing here falls back to the
CPU: :func:`cuda_device` raises when there is no card, and every engine
entry point runs on the card unless the caller asks for the CPU
(:func:`resolve_device`).
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["pin_fp32", "true_div", "cuda_device", "resolve_device",
           "card_info"]


def pin_fp32() -> None:
    """Full fp32 everywhere: no TF32 in matmuls or convolutions.

    The GPU form of the TPU lesson that reduced-precision matmul operands
    biased ICP (ARCHITECTURE.md:100-106).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as IEEE division on every device.

    On a CUDA tensor, PyTorch turns division by a Python scalar into a
    multiplication by its reciprocal, which can differ from ``x / c`` in
    the last bit; the CPU, the JAX reference and the kernels divide.  A
    0-d tensor on ``x``'s device keeps the true division.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``, with the fp32 pins set; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    pin_fp32()
    return torch.device("cuda", index)


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: the card for ``None`` or a CUDA
    device (:func:`cuda_device`, which raises without a card), the CPU only
    when the caller names it."""
    if device is None:
        return cuda_device()
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_device(device.index or 0)
    return device


def card_info() -> str:
    """``name, power.limit`` of the cards, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
