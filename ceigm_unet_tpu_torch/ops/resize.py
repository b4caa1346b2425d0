"""Exact ``scipy.ndimage.zoom`` as matrix products on the device.

Counterpart of ``ceigm_unet_tpu/ops/resize.py``. An order-k spline zoom is a
linear map of its input, so for fixed sizes it is one dense (out, in) matrix
per axis, extracted on the host by pushing unit vectors through scipy once
per shape. Order-0 (nearest) zooms are a gather with scipy's exact index map.
On the host, :func:`zoom_host` applies a higher order's operator as a band
through the native resize (``ceigm_unet_tpu_torch/native``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ceigm_unet_tpu_torch import native as native_lib


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


# entries of the dense operator below this are dropped from its band
BAND_THRESH = 1e-7


@functools.lru_cache(maxsize=128)
def zoom_band(in_size: int, out_size: int, order: int = 3, taps: int = 0):
    """Banded form of :func:`zoom_matrix`: (starts int32 (out,), weights
    float32 (out, taps), taps). Rows of the cubic operator decay as
    |sqrt(3) - 2|^d, so dropping entries below ``BAND_THRESH`` keeps a band of
    ~24 taps and the dense operator to ~1e-7. ``taps`` widens the band to a
    given width (at least the natural one), so both axes of one resize can
    share it."""
    m = zoom_matrix(in_size, out_size, order).astype(np.float32)
    m = np.where(np.abs(m) > BAND_THRESH, m, 0.0)
    widths, firsts = [], []
    for r in m:
        nzi = np.nonzero(r)[0]
        firsts.append(int(nzi.min()) if nzi.size else 0)
        widths.append(int(nzi.max() - nzi.min() + 1) if nzi.size else 1)
    natural = min(max(widths), in_size)
    if taps and not natural <= taps <= in_size:
        raise ValueError(f"a band of {taps} taps for {in_size} -> "
                         f"{out_size} (natural width {natural})")
    taps = taps or natural
    starts = np.minimum(np.asarray(firsts, np.int64),
                        in_size - taps).astype(np.int32)
    weights = np.zeros((out_size, taps), np.float32)
    for o in range(out_size):
        weights[o] = m[o, starts[o]:starts[o] + taps]
    return starts, weights, taps


def zoom_host(img: np.ndarray, out_hw: Tuple[int, int],
              order: int = 3) -> np.ndarray:
    """scipy-parity zoom of one 2-D slice on the host, numpy in and out
    (float32). Order 0 is scipy's index map; a higher order runs the
    extracted operator as the native banded resize (``native.sep_resize``,
    the JAX package's loader path) where the band fits the slice, else as
    :func:`zoom_slices` on a CPU tensor."""
    H, W = img.shape
    Ho, Wo = out_hw
    if order > 0 and (H, W) != (Ho, Wo):
        t = max(zoom_band(H, Ho, order)[2], zoom_band(W, Wo, order)[2])
        if t <= H and t <= W:
            ys, yw, _ = zoom_band(H, Ho, order, taps=t)
            xs, xw, _ = zoom_band(W, Wo, order, taps=t)
            return native_lib.sep_resize(img, ys, yw, xs, xw, t)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    y = zoom_slices_nearest(x, out_hw) if order == 0 else zoom_slices(
        x, out_hw, order)
    return y.numpy()
