"""Segmentation metrics, on the host.

Counterpart of ``ceigm_unet_tpu/eval/metrics.py``, with its conventions:

- Dice on binary masks keeps the reference's quirk "pred non-empty and gt
  empty -> 1.0, both empty -> 0.0" (gm-unet/utils.py:46-55).
- Class maps for Synapse (8 organs) and ACDC (3 structures)
  (utils.py:8-28).
- The test-time suite dice / hd95 / jaccard / asd follows
  ``medpy.metric.binary``: surfaces by one binary erosion with a full
  3x3(x3) structure, distances by scipy's exact EDT. numpy and scipy on the
  host, off the model's path.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

SYNAPSE_CLASS_COLOR_MAP = {
    "aorta": (1, [30, 144, 255]),
    "gallbladder": (2, [0, 255, 0]),
    "left_kidney": (3, [255, 0, 0]),
    "right_kidney": (4, [0, 255, 255]),
    "liver": (5, [255, 0, 255]),
    "pancreas": (6, [255, 255, 0]),
    "spleen": (7, [128, 0, 255]),
    "stomach": (8, [255, 128, 0]),
}

ACDC_CLASS_COLOR_MAP = {
    "RV": (1, [30, 144, 255]),
    "Myo": (2, [0, 255, 0]),
    "LV": (3, [255, 0, 0]),
}

CLASS_COLOR_MAPS = {4: ACDC_CLASS_COLOR_MAP, 9: SYNAPSE_CLASS_COLOR_MAP}


def dice_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """2|p & g| / (|p| + |g|), with the reference's empty-mask quirk."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    ps, gs = pred.sum(), gt.sum()
    if ps > 0 and gs > 0:
        return float(2.0 * np.logical_and(pred, gt).sum() / (ps + gs))
    if ps > 0 and gs == 0:
        return 1.0
    return 0.0


def jaccard_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """|p & g| / |p | g|; 0.0 when both masks are empty."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(pred, gt).sum() / union)


def _surface_distances(pred: np.ndarray, gt: np.ndarray,
                       spacing=None) -> np.ndarray:
    """Distances from pred's surface voxels to gt's surface (medpy's
    ``__surface_distances``: a surface is a mask minus its erosion)."""
    from scipy.ndimage import binary_erosion, distance_transform_edt
    pred = np.atleast_1d(np.asarray(pred).astype(bool))
    gt = np.atleast_1d(np.asarray(gt).astype(bool))
    conn = np.ones((3,) * pred.ndim, bool)
    pred_border = pred ^ binary_erosion(pred, structure=conn, iterations=1)
    gt_border = gt ^ binary_erosion(gt, structure=conn, iterations=1)
    dt = distance_transform_edt(~gt_border, sampling=spacing)
    return dt[pred_border]


def surface_metrics(pred: np.ndarray, gt: np.ndarray,
                    spacing=None) -> Dict[str, float]:
    """hd95 and asd as ``medpy.metric.binary.hd95`` / ``.asd``; NaN for
    both when either mask is empty (medpy raises there, and the reference
    calls them on non-empty classes only)."""
    if not np.any(pred) or not np.any(gt):
        return {"hd95": float("nan"), "asd": float("nan")}
    d_pg = _surface_distances(pred, gt, spacing)
    d_gp = _surface_distances(gt, pred, spacing)
    hd95 = float(np.percentile(np.hstack([d_pg, d_gp]), 95))
    asd = float(d_pg.mean())
    return {"hd95": hd95, "asd": asd}


class SegMeter:
    """Per-class dice accumulator (reference eval.py:9-45)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.values = defaultdict(list)

    def __call__(self, pred: np.ndarray, label: np.ndarray):
        """pred, label: (B, [D,] H, W) integer class maps."""
        pred = np.asarray(pred)
        label = np.asarray(label)
        for b in range(pred.shape[0]):
            for cls_name, (idx, _) in CLASS_COLOR_MAPS[
                    self.num_classes].items():
                self.values[cls_name].append(
                    dice_binary(pred[b] == idx, label[b] == idx))

    def get_metric(self) -> Dict[str, Dict[str, list]]:
        return {"dice": dict(self.values)}

    def mean_dice(self) -> float:
        per_class = [float(np.mean(v)) for v in self.values.values()]
        return float(np.mean(per_class)) if per_class else 0.0
