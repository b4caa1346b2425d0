"""Batched per-volume inference.

Counterpart of ``ceigm_unet_tpu/eval/volume.py`` ``predict_volume``: the
volume's slices go to the model's device in batches; each batch is zoomed
to the patch size (exact scipy order-3 zoom as matrix products),
normalised, run through the model, argmaxed and zoomed back with scipy's
order-0 index map. The host touches the data twice: upload and download.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ceigm_unet_tpu_torch.ops.resize import zoom_slices, zoom_slices_nearest


@torch.no_grad()
def _predict_batch(model: torch.nn.Module, slices: torch.Tensor,
                  patch: Tuple[int, int],
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """slices (B, H, W) raw -> (B, H, W) int64 class map at out_hw."""
    x = zoom_slices(slices, patch, order=3)
    x = (x - 0.5) / 0.5              # Normalize(0.5, 0.5), as in training
    logits = model(x[..., None])                       # (B, p, p, classes)
    return zoom_slices_nearest(torch.argmax(logits, dim=-1), out_hw)


def predict_volume(model: torch.nn.Module, volume: np.ndarray,
                   patch_size: Tuple[int, int] = (224, 224),
                   batch_size: int = 32) -> np.ndarray:
    """volume (D, H, W) float -> (D, H, W) int class map. Runs on the
    device of the model's parameters; the last batch is zero-padded."""
    device = next(model.parameters()).device
    D, H, W = volume.shape
    pad = (-D) % batch_size
    vol = np.concatenate([volume, np.zeros((pad, H, W), volume.dtype)]) \
        if pad else volume
    preds = []
    for i in range(0, vol.shape[0], batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(
            vol[i:i + batch_size], np.float32)).to(device)
        preds.append(_predict_batch(model, chunk, tuple(patch_size),
                                   (H, W)).cpu().numpy())
    return np.concatenate(preds)[:D]
