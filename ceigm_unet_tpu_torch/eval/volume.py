"""Batched per-volume inference.

Counterpart of ``ceigm_unet_tpu/eval/volume.py`` ``predict_volume``: the
volume's slices go to the model's device in batches; each batch is zoomed
to the patch size (exact scipy order-3 zoom as matrix products),
normalised, run through the model, argmaxed and zoomed back with scipy's
order-0 index map. ``eval_single_volume`` scores the map with ``SegMeter``
on the host.

The copy path. Each batch's real rows are uploaded straight from the
caller's array into a device batch whose other rows are zeroed on the
device, so the forward sees full, zero-padded batches and the host makes
no padded copy. The argmax is narrowed on the device to ``uint8`` (at most
256 classes) or ``int32`` before the zoom back, and each batch's map is
copied asynchronously into its rows of one staging buffer: pinned host
memory on CUDA, ordinary host memory on the CPU, one per thread and
device, grown to the largest padded volume seen (D_pad x H x W of the
narrow dtype; 64 MiB for 256 slices of 512²) and kept for the process's
life. After one wait for the last copy the host widens the first D rows
once into the ``int32`` array it returns (the JAX package's dtype), never
a view of the staging buffer.

Spans (``utils/spans.py``, recorded only under a profiler): one
``predict_volume`` per call, its request a per-process volume number, with
counts ``slices`` (D), ``padded`` (zero slices added to fill the last
batch) and ``batches``; inside it per batch ``.upload`` (the last batch's
holds ``predict_volume.pad``, its zero fill), ``.zoom``, ``.model``,
``.argmax``, ``.zoom_back`` and ``.download`` (count ``bytes``: the map
bytes that crossed, 1 a pixel on the narrow path), then ``.wait`` (for the
last copy) and ``.gather`` (the widening write into the returned array).
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ceigm_unet_tpu_torch.eval.metrics import SegMeter
from ceigm_unet_tpu_torch.ops.resize import zoom_slices, zoom_slices_nearest
from ceigm_unet_tpu_torch.utils.spans import span

_volumes = itertools.count()      # the request number of each volume


class _Staging(threading.local):
    """This thread's staging buffers, one byte buffer per device."""

    def __init__(self):
        self.bufs: Dict[torch.device, torch.Tensor] = {}


_staging = _Staging()


def _map_dtype(num_classes: int) -> torch.dtype:
    """The narrowest dtype that holds every class index."""
    return torch.uint8 if num_classes <= 256 else torch.int32


@torch.no_grad()
def _predict_batch(model: torch.nn.Module, slices: torch.Tensor,
                   patch: Tuple[int, int],
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """slices (B, H, W) raw -> (B, H, W) class map at out_hw, ``uint8`` or
    ``int32`` (:func:`_map_dtype` of the logits' class count)."""
    with span("predict_volume.zoom"):
        x = zoom_slices(slices, patch, order=3)
        x = (x - 0.5) / 0.5          # Normalize(0.5, 0.5), as in training
    with span("predict_volume.model"):
        logits = model(x[..., None])                   # (B, p, p, classes)
    with span("predict_volume.argmax"):
        classes = torch.argmax(logits, dim=-1).to(
            _map_dtype(logits.shape[-1]))
    with span("predict_volume.zoom_back"):
        return zoom_slices_nearest(classes, out_hw)


def _staged(device: torch.device, shape: Tuple[int, ...],
            dtype: torch.dtype) -> torch.Tensor:
    """``shape`` rows of ``dtype`` over this thread's staging buffer for
    ``device``, grown (pinned on CUDA) when the volume needs more."""
    n = int(np.prod(shape)) * dtype.itemsize
    buf = _staging.bufs.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        _staging.bufs[device] = buf
    return buf[:n].view(dtype).view(shape)


def _download(classes: torch.Tensor, rows: torch.Tensor) -> None:
    """The batch's class map into its staging rows, asynchronously on the
    current stream (cast there if it came in another dtype)."""
    with span("predict_volume.download",
              bytes=rows.numel() * rows.element_size()):
        rows.copy_(classes, non_blocking=True)


def _wait(device: torch.device) -> None:
    """Until every copy queued on the device's current stream is done."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def predict_volume(model: torch.nn.Module, volume: np.ndarray,
                   patch_size: Tuple[int, int] = (224, 224),
                   batch_size: int = 32) -> np.ndarray:
    """volume (D, H, W) float -> (D, H, W) int32 class map. Runs on the
    device of the model's parameters; the last batch is zero-padded."""
    device = next(model.parameters()).device
    D, H, W = volume.shape
    pad = (-D) % batch_size
    staged = None
    with span("predict_volume", request=next(_volumes), slices=D,
              padded=pad, batches=(D + pad) // batch_size):
        for i in range(0, D, batch_size):
            n = min(batch_size, D - i)
            with span("predict_volume.upload"):
                chunk = torch.empty((batch_size, H, W), dtype=torch.float32,
                                    device=device)
                chunk[:n].copy_(torch.from_numpy(np.ascontiguousarray(
                    volume[i:i + n], np.float32)))
                if i + batch_size >= D:
                    with span("predict_volume.pad"):
                        chunk[n:].zero_()
            classes = _predict_batch(model, chunk, tuple(patch_size), (H, W))
            if staged is None:       # the first map sets the staged dtype
                staged = _staged(device, (D + pad, H, W), classes.dtype)
            _download(classes, staged[i:i + batch_size])
            del classes       # nothing keeps it alive into the next batch
        with span("predict_volume.wait"):
            _wait(device)
        with span("predict_volume.gather"):
            out = np.empty((D, H, W), np.int32)
            np.copyto(out, staged[:D].numpy())
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
