"""Batched per-volume inference.

Counterpart of ``ceigm_unet_tpu/eval/volume.py`` ``predict_volume``: the
volume's slices go to the model's device in batches; each batch is zoomed
to the patch size (exact scipy order-3 zoom as matrix products),
normalised, run through the model, argmaxed and zoomed back with scipy's
order-0 index map. The host touches the data twice: upload and download.
``eval_single_volume`` scores the map with ``SegMeter`` on the host.

Spans (``utils/spans.py``, recorded only under a profiler): one
``predict_volume`` per call, its request a per-process volume number, with
counts ``slices`` (D), ``padded`` (zero slices added to fill the last
batch) and ``batches``; inside it ``predict_volume.pad``, then per batch
``.upload``, ``.zoom``, ``.model``, ``.argmax``, ``.zoom_back`` and
``.download``, then ``.gather`` (the maps joined and cut to D, and the
batches' maps and the padded copy released).
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ceigm_unet_tpu_torch.eval.metrics import SegMeter
from ceigm_unet_tpu_torch.ops.resize import zoom_slices, zoom_slices_nearest
from ceigm_unet_tpu_torch.utils.spans import span

_volumes = itertools.count()      # the request number of each volume


@torch.no_grad()
def _predict_batch(model: torch.nn.Module, slices: torch.Tensor,
                  patch: Tuple[int, int],
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """slices (B, H, W) raw -> (B, H, W) int64 class map at out_hw."""
    with span("predict_volume.zoom"):
        x = zoom_slices(slices, patch, order=3)
        x = (x - 0.5) / 0.5          # Normalize(0.5, 0.5), as in training
    with span("predict_volume.model"):
        logits = model(x[..., None])                   # (B, p, p, classes)
    with span("predict_volume.argmax"):
        classes = torch.argmax(logits, dim=-1)
    with span("predict_volume.zoom_back"):
        return zoom_slices_nearest(classes, out_hw)


def _download(classes: torch.Tensor) -> np.ndarray:
    """The batch's class map on the host; nothing keeps the device copy
    alive into the next batch."""
    with span("predict_volume.download"):
        return classes.cpu().numpy()


def predict_volume(model: torch.nn.Module, volume: np.ndarray,
                   patch_size: Tuple[int, int] = (224, 224),
                   batch_size: int = 32) -> np.ndarray:
    """volume (D, H, W) float -> (D, H, W) int class map. Runs on the
    device of the model's parameters; the last batch is zero-padded."""
    device = next(model.parameters()).device
    D, H, W = volume.shape
    pad = (-D) % batch_size
    with span("predict_volume", request=next(_volumes), slices=D,
              padded=pad, batches=(D + pad) // batch_size):
        with span("predict_volume.pad"):
            vol = np.concatenate([volume, np.zeros((pad, H, W),
                                                   volume.dtype)]) \
                if pad else volume
        preds = []
        for i in range(0, vol.shape[0], batch_size):
            with span("predict_volume.upload"):
                chunk = torch.from_numpy(np.ascontiguousarray(
                    vol[i:i + batch_size], np.float32)).to(device)
            preds.append(_download(_predict_batch(model, chunk,
                                                  tuple(patch_size), (H, W))))
        with span("predict_volume.gather"):
            out = np.concatenate(preds)[:D]
            del preds, vol      # the batches' maps and the padded copy
            return out


def eval_single_volume(model: torch.nn.Module, volume: np.ndarray,
                       label: np.ndarray, num_classes: int,
                       patch_size: Tuple[int, int] = (224, 224),
                       batch_size: int = 32) -> Dict:
    """Reference ``eval_single_volume`` (eval.py:47-88): the volume's
    per-class dice as ``{"dice": {class_name: [value]}}``."""
    pred = predict_volume(model, volume, patch_size, batch_size)
    meter = SegMeter(num_classes=num_classes)
    meter(pred[None], np.asarray(label)[None])
    return meter.get_metric()
