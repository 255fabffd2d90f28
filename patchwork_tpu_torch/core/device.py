"""The CUDA device, the fp32 pins, and the card's identity.

Counterpart of ``patchwork_tpu/core/device.py``.  Unlike the reference's
CudaManager (cuda/cuda_interface.cu:44-95) nothing here falls back to the
CPU: :func:`cuda_device` raises when there is no card, and every engine
entry point runs on the card unless the caller asks for the CPU
(:func:`resolve_device`).  The CudaManager's introspection is here too
(:func:`accelerator_available`, :func:`initialize`, :func:`cleanup`,
:func:`device_info`).  The JAX package's ``enable_compilation_cache`` has
no counterpart: nothing here is compiled per shape (the kernels are built
once per source, ``kernels/_build.py``).
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import torch

__all__ = ["pin_fp32", "true_div", "cuda_device", "resolve_device",
           "card_info", "accelerator_available", "initialize", "cleanup",
           "device_info"]


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


def accelerator_available() -> bool:
    """True when a CUDA card is visible (CudaManager::isAvailable)."""
    return torch.cuda.is_available()


def initialize() -> bool:
    """Initialise CUDA now rather than at the first kernel; returns
    :func:`accelerator_available` (CudaManager::initialize,
    cuda_interface.cu:61-88)."""
    if not torch.cuda.is_available():
        return False
    torch.cuda.init()
    return True


def cleanup() -> None:
    """Release the caching allocator's free blocks and the kernels'
    per-device scratch (CudaManager::cleanup)."""
    if not torch.cuda.is_available():
        return
    from ..kernels import fit_cuda

    fit_cuda._WORKSPACE.clear()
    torch.cuda.empty_cache()


def device_info() -> List[Dict[str, str]]:
    """One record per visible CUDA device: ``id``, ``platform`` ("gpu"),
    ``kind`` (the device name) and ``process`` (this rank of the
    ``torch.distributed`` group, 0 outside one); empty without a card."""
    if not torch.cuda.is_available():
        return []
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    return [{"id": str(i), "platform": "gpu",
             "kind": torch.cuda.get_device_name(i), "process": str(rank)}
            for i in range(torch.cuda.device_count())]
