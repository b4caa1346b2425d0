"""Overlays of label and prediction maps (reference gm-unet/plot.py:65-190).

Counterpart of ``ceigm_unet_tpu/eval/plot.py``: each class is filled in its
colour at alpha 0.6 over the grayscale slice and outlined with a contour
darkened or brightened by the colour's luminance. ``cv2`` is imported where
it is used, so the module imports without it.
"""
from __future__ import annotations

import os

import numpy as np

from ceigm_unet_tpu_torch.eval.metrics import CLASS_COLOR_MAPS

ALPHA = 0.6


def _to_bgr_u8(img: np.ndarray) -> np.ndarray:
    x = np.asarray(img, np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi > lo:
        x = (x - lo) / (hi - lo)
    u8 = (x * 255).astype(np.uint8)
    return np.stack([u8, u8, u8], axis=-1)


def overlay(img: np.ndarray, mask: np.ndarray, num_classes: int
            ) -> np.ndarray:
    """img (H, W) float, mask (H, W) int -> (H, W, 3) BGR uint8."""
    import cv2
    canvas = _to_bgr_u8(img)
    for _, (idx, rgb) in CLASS_COLOR_MAPS[num_classes].items():
        m = (np.asarray(mask) == idx).astype(np.uint8)
        if not m.any():
            continue
        color = np.array(rgb[::-1], np.uint8)          # RGB -> BGR
        fill = canvas.copy()
        fill[m > 0] = color
        canvas = cv2.addWeighted(fill, ALPHA, canvas, 1 - ALPHA, 0)
        contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        # a bright colour gets a darker outline, a dark one a brighter
        lum = 0.114 * rgb[2] + 0.587 * rgb[1] + 0.299 * rgb[0]
        cc = tuple(min(255, int(c * (0.5 if lum > 128 else 1.5)))
                   for c in color)
        cv2.drawContours(canvas, contours, -1, cc, 1)
    return canvas


def save_x_y(img: np.ndarray, label: np.ndarray, num_classes: int,
             path: str):
    """Writes the overlay of ``label`` on ``img`` to the image file
    ``path``."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, overlay(img, label, num_classes))


def save_x_y_hat(img: np.ndarray, label: np.ndarray, pred: np.ndarray,
                 num_classes: int, path_y: str, path_y_hat: str):
    """Writes the label's overlay to ``path_y`` and the prediction's to
    ``path_y_hat``."""
    save_x_y(img, label, num_classes, path_y)
    save_x_y(img, pred, num_classes, path_y_hat)
