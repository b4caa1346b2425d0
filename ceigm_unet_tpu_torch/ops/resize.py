"""Exact ``scipy.ndimage.zoom`` as matrix products on the device.

Counterpart of ``ceigm_unet_tpu/ops/resize.py``. An order-k spline zoom is a
linear map of its input, so for fixed sizes it is one dense (out, in) matrix
per axis, extracted on the host by pushing unit vectors through scipy once
per shape. Order-0 (nearest) zooms are a gather with scipy's exact index map.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def zoom_matrix(in_size: int, out_size: int, order: int = 3) -> np.ndarray:
    """(out_size, in_size) matrix M with zoom(v) == M @ v for 1-D v."""
    from scipy.ndimage import zoom as _zoom
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    for j in range(in_size):
        e = np.zeros(in_size, np.float64)
        e[j] = 1.0
        col = _zoom(e, out_size / in_size, order=order)
        if col.shape[0] != out_size:
            raise ValueError(f"scipy zoom gave {col.shape[0]} samples, "
                             f"expected {out_size}")
        m[:, j] = col.astype(np.float32)
    return m


@functools.lru_cache(maxsize=128)
def nearest_index_map(in_size: int, out_size: int):
    """(source index per output, validity mask) of scipy's order-0 zoom;
    invalid outputs take scipy's constant fill 0."""
    if in_size == out_size:
        return np.arange(in_size, dtype=np.int64), np.ones(in_size, bool)
    m = zoom_matrix(in_size, out_size, order=0)
    return np.argmax(m, axis=1).astype(np.int64), m.sum(axis=1) > 0


def zoom_slices(x: torch.Tensor, out_hw: Tuple[int, int],
                order: int = 3) -> torch.Tensor:
    """Exact zoom of (..., H, W) slices to (..., H', W'), in fp32."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    mh = torch.from_numpy(zoom_matrix(H, Ho, order)).to(x.device)
    mw = torch.from_numpy(zoom_matrix(W, Wo, order)).to(x.device)
    return mh @ x.float() @ mw.t()


def zoom_slices_nearest(x: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Order-0 zoom (labels, predictions) of (..., H, W)."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    ih, vh = nearest_index_map(H, Ho)
    iw, vw = nearest_index_map(W, Wo)
    dev = x.device
    y = x[..., torch.from_numpy(ih).to(dev), :][..., torch.from_numpy(iw)
                                                .to(dev)]
    mask = torch.from_numpy(np.outer(vh, vw)).to(dev)
    return torch.where(mask, y, torch.zeros_like(y))


def zoom_host(img: np.ndarray, out_hw: Tuple[int, int],
              order: int = 3) -> np.ndarray:
    """scipy-parity zoom of one 2-D slice on the host, numpy in and out
    (float32): :func:`zoom_slices_nearest` for order 0, else
    :func:`zoom_slices`, on a CPU tensor."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    y = zoom_slices_nearest(x, out_hw) if order == 0 else zoom_slices(
        x, out_hw, order)
    return y.numpy()
