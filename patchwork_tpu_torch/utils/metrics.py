"""Segmentation quality metrics (IoU / F1 / precision / recall).

A NumPy copy of ``patchwork_tpu/utils/metrics.py``.

The reference's tests assert only structural facts (counts conserved,
non-empty; test_recursive_patchwork.cpp:74-76); BASELINE.md demands real
IoU/F1 parity on labeled data (KITTI-360 semantics labels, or synthetic
by-construction labels).  These helpers compute them from boolean masks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["mask_metrics", "format_metrics"]


def mask_metrics(pred: np.ndarray, truth: np.ndarray,
                 valid: np.ndarray | None = None) -> Dict[str, float]:
    """IoU/F1/precision/recall of a predicted ground mask vs labels."""
    pred = np.asarray(pred, bool)
    truth = np.asarray(truth, bool)
    if valid is not None:
        valid = np.asarray(valid, bool)
        pred, truth = pred[valid], truth[valid]
    tp = float((pred & truth).sum())
    fp = float((pred & ~truth).sum())
    fn = float((~pred & truth).sum())
    union = tp + fp + fn
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    return {
        "iou": tp / max(union, 1.0),
        "f1": 2.0 * precision * recall / max(precision + recall, 1e-12),
        "precision": precision,
        "recall": recall,
        "tp": tp,
        "fp": fp,
        "fn": fn,
    }


def format_metrics(m: Dict[str, float]) -> str:
    return (
        f"IoU {m['iou']:.4f}  F1 {m['f1']:.4f}  "
        f"P {m['precision']:.4f}  R {m['recall']:.4f}"
    )
