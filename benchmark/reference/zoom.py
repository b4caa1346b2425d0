"""Plain reference of the served resizes: scipy's spline zoom, slice by
slice on the host."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def zoom_cubic(slices: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W) -> (N, H', W') by scipy's order-3 zoom (float64 inside),
    returned as float32."""
    N, H, W = slices.shape
    f = (out_hw[0] / H, out_hw[1] / W)
    return np.stack([ndimage.zoom(s.astype(np.float64), f, order=3)
                     for s in slices]).astype(np.float32)


def zoom_nearest(maps: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, h, w) integer maps -> (N, H', W') by scipy's order-0 zoom."""
    N, h, w = maps.shape
    f = (out_hw[0] / h, out_hw[1] / w)
    return np.stack([ndimage.zoom(m, f, order=0) for m in maps])
