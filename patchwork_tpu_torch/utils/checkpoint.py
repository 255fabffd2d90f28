"""Persistence of per-frame segmentation masks.

Counterpart of the mask half of ``patchwork_tpu/utils/checkpoint.py``:
packed bits in a plain ``.npz``, readable by either package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["save_masks", "load_masks"]


def save_masks(path: str, ground: np.ndarray, valid: np.ndarray,
               frame_ids: Optional[np.ndarray] = None) -> None:
    """Persist per-frame segmentation masks ((F, N) bool, packed)."""
    np.savez_compressed(
        path,
        ground=np.packbits(np.asarray(ground, bool), axis=-1),
        valid=np.packbits(np.asarray(valid, bool), axis=-1),
        n=np.int64(np.asarray(ground).shape[-1]),
        frame_ids=(frame_ids if frame_ids is not None
                   else np.arange(len(ground), dtype=np.int64)),
    )


def load_masks(path: str):
    """(ground (F, N) bool, valid (F, N) bool, frame_ids (F,))."""
    with np.load(path) as f:
        n = int(f["n"])
        ground = np.unpackbits(f["ground"], axis=-1)[..., :n].astype(bool)
        valid = np.unpackbits(f["valid"], axis=-1)[..., :n].astype(bool)
        return ground, valid, f["frame_ids"].copy()
