"""Native (C++) host kernels of the CPU augmentation pipeline.

Counterpart of ``ceigm_unet_tpu/native``, built from this package's own
copy of ``augwarp.cpp``: at first use ``g++`` compiles it into
``ceigm_unet_tpu_torch/_build/``, keyed by a hash of the source and the
flags, through a unique temporary file and an atomic rename, so processes
that race on the first build each find the finished library or write an
identical one. A failed build raises; nothing falls back to scipy.

The three warps reproduce scipy.ndimage's ``mode='constant'`` sampling
(``augwarp.cpp`` says how) in one pass each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "augwarp.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"augwarp_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``augwarp.cpp`` unless the library of this source is built.
    Returns its path; raises if ``g++`` fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    i, d, f = ctypes.c_int, ctypes.c_double, ctypes.c_float
    lib.affine_warp_f32.argtypes = [fp, i, i, d, d, d, d, d, d, i, f, fp]
    lib.piecewise_warp_f32.argtypes = [fp, fp, i, i, dp, dp, i, f, fp, fp]
    lib.sep_resize_f32.argtypes = [fp, i, i, ip, fp, i, ip, fp, i, i, fp,
                                   fp]
    for fn in (lib.affine_warp_f32, lib.piecewise_warp_f32,
               lib.sep_resize_f32):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32_2d(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2:
        raise ValueError(f"expected a 2-D slice, got shape {a.shape}")
    return a


def affine_warp(src: np.ndarray, m: np.ndarray, off: np.ndarray,
                order: int, cval: float = 0.0) -> np.ndarray:
    """``scipy.ndimage.affine_transform(src, m, offset=off, order=order,
    mode='constant', cval=cval)`` of a float32 2-D array (order 0 or 1)."""
    if order not in (0, 1):
        raise ValueError(f"affine_warp takes order 0 or 1, got {order}")
    src = _f32_2d(src)
    h, w = src.shape
    out = np.empty_like(src)
    library().affine_warp_f32(
        _ptr(src, ctypes.c_float), h, w,
        float(m[0, 0]), float(m[0, 1]), float(m[1, 0]), float(m[1, 1]),
        float(off[0]), float(off[1]), int(order), float(cval),
        _ptr(out, ctypes.c_float))
    return out


def piecewise_warp(img: np.ndarray, lab: np.ndarray, aff: np.ndarray,
                   verts: np.ndarray, cval: float = 0.0):
    """Piecewise-affine warp of an image (order 1) and a label (order 0)
    through the same per-triangle maps.

    aff:   (ns, 6) float64 [a00, a01, b0, a10, a11, b1] per triangle
           (cy = a00*y + a01*x + b0; cx = a10*y + a11*x + b1)
    verts: (ns, 6) float64 [y0, x0, y1, x1, y2, x2] per triangle
    """
    img, lab = _f32_2d(img), _f32_2d(lab)
    aff = np.ascontiguousarray(aff, np.float64)
    verts = np.ascontiguousarray(verts, np.float64)
    ns = aff.shape[0]
    if img.shape != lab.shape or aff.shape != (ns, 6) or \
            verts.shape != (ns, 6) or ns > 256:
        raise ValueError(f"piecewise_warp: image {img.shape}, label "
                         f"{lab.shape}, aff {aff.shape}, verts "
                         f"{verts.shape} (at most 256 triangles)")
    h, w = img.shape
    oimg, olab = np.empty_like(img), np.empty_like(lab)
    library().piecewise_warp_f32(
        _ptr(img, ctypes.c_float), _ptr(lab, ctypes.c_float), h, w,
        _ptr(aff, ctypes.c_double), _ptr(verts, ctypes.c_double), ns,
        float(cval), _ptr(oimg, ctypes.c_float), _ptr(olab, ctypes.c_float))
    return oimg, olab


def sep_resize(src: np.ndarray, ys: np.ndarray, yw: np.ndarray,
               xs: np.ndarray, xw: np.ndarray, taps: int) -> np.ndarray:
    """A separable banded linear resize (``ops/resize.py`` ``zoom_band``'s
    starts and weights per axis) in one pass."""
    src = _f32_2d(src)
    h, w = src.shape
    ys, xs = (np.ascontiguousarray(a, np.int32) for a in (ys, xs))
    yw, xw = (np.ascontiguousarray(a, np.float32) for a in (yw, xw))
    ho, wo = ys.shape[0], xs.shape[0]
    if yw.shape != (ho, taps) or xw.shape != (wo, taps) or \
            ys.max(initial=0) + taps > h or xs.max(initial=0) + taps > w:
        raise ValueError(f"sep_resize: a band of {taps} taps does not fit "
                         f"a {h}x{w} source")
    tmp = np.empty((ho, w), np.float32)
    out = np.empty((ho, wo), np.float32)
    library().sep_resize_f32(
        _ptr(src, ctypes.c_float), h, w, _ptr(ys, ctypes.c_int32),
        _ptr(yw, ctypes.c_float), ho, _ptr(xs, ctypes.c_int32),
        _ptr(xw, ctypes.c_float), wo, int(taps), _ptr(tmp, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    return out
