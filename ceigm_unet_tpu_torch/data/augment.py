"""CPU augmentation policy (the host tier).

Counterpart of ``ceigm_unet_tpu/data/augment.py``, one for one, and from the
same ``np.random.Generator`` state it gives the same bytes. It is the
reference's imgaug policy (gm-unet/dataset_synapse.py:61-72), written from
imgaug's documented semantics in numpy and scipy:

    SomeOf((0, 4)), random order, each op applied to image and label:
      Flipud(0.5), Fliplr(0.5), AdditiveGaussianNoise(0.005*255),
      GaussianBlur(sigma=1.0), LinearContrast((0.5, 1.5)),
      Affine(scale x/y (0.5, 2)), Affine(rotate ±40°), Affine(shear ±16°),
      PiecewiseAffine(scale (0.008, 0.03)), Affine(translate ±20%)

Geometric ops warp around the image center, order 1 for the image and
order 0 for the label, constant fill 0, on the native warp
(``ceigm_unet_tpu_torch/native``), which samples as ``scipy.ndimage``'s
``mode='constant'`` does. PiecewiseAffine is skimage's
PiecewiseAffineTransform, which imgaug delegates to: a 4x4 control grid
with its borders, jittered by N(0, scale * size), and one affine per
triangle of the source grid's Delaunay triangulation.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
from scipy import ndimage

from ceigm_unet_tpu_torch import native as native_lib

Sample = Tuple[np.ndarray, np.ndarray]   # image (H, W), label (H, W)


def _affine_matrix(scale=(1.0, 1.0), rotate_deg=0.0, shear_deg=0.0,
                   translate=(0.0, 0.0), center=(0.0, 0.0)) -> np.ndarray:
    """Forward 3x3 affine in (x, y) convention, centered at ``center``."""
    sx, sy = scale
    r = np.deg2rad(rotate_deg)
    sh = np.deg2rad(shear_deg)
    cx, cy = center
    # imgaug's order: scale, translate, rotate, shear around the center
    S = np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1.0]])
    T = np.array([[1, 0, translate[0]], [0, 1, translate[1]], [0, 0, 1.0]])
    R = np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0],
                  [0, 0, 1.0]])
    Sh = np.array([[1, -np.sin(sh), 0], [0, np.cos(sh), 0], [0, 0, 1.0]])
    C = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    Ci = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    return C @ Sh @ R @ T @ S @ Ci


def _apply_affine(img: np.ndarray, mat: np.ndarray,
                  order: int) -> np.ndarray:
    """Warp with the forward matrix ``mat`` ((x, y) convention)."""
    inv = np.linalg.inv(mat)
    # scipy works in (row, col) = (y, x)
    m = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
    off = np.array([inv[1, 2], inv[0, 2]])
    return native_lib.affine_warp(np.asarray(img, np.float32), m, off, order)


class _Op(NamedTuple):
    name: str
    fn: Callable  # (rng, img, lab) -> (img, lab)


def _geom(img, lab, **kw):
    h, w = img.shape
    mat = _affine_matrix(center=((w - 1) / 2, (h - 1) / 2), **kw)
    return (_apply_affine(img, mat, 1),
            _apply_affine(lab, mat, 0))


def _op_flipud(rng, img, lab):
    if rng.random() < 0.5:
        return img[::-1].copy(), lab[::-1].copy()
    return img, lab


def _op_fliplr(rng, img, lab):
    if rng.random() < 0.5:
        return img[:, ::-1].copy(), lab[:, ::-1].copy()
    return img, lab


def _op_noise(rng, img, lab):
    n = rng.standard_normal(img.shape, dtype=np.float32)
    return img + n * np.float32(0.005 * 255), lab


def _op_blur(rng, img, lab):
    return ndimage.gaussian_filter(img, 1.0, output=np.float32), lab


def _op_contrast(rng, img, lab):
    alpha = rng.uniform(0.5, 1.5)
    # imgaug pivots at 127 for uint8 data; these slices are [0, 1] floats,
    # so the pivot is 0.5 of their range
    pivot = 0.5 if img.max() <= 2.0 else 127.0
    return ((img - pivot) * alpha + pivot).astype(np.float32), lab


def _op_scale(rng, img, lab):
    return _geom(img, lab,
                 scale=(rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0)))


def _op_rotate(rng, img, lab):
    return _geom(img, lab, rotate_deg=rng.uniform(-40, 40))


def _op_shear(rng, img, lab):
    return _geom(img, lab, shear_deg=rng.uniform(-16, 16))


def _op_translate(rng, img, lab):
    h, w = img.shape
    return _geom(img, lab,
                 translate=(rng.uniform(-0.2, 0.2) * w,
                            rng.uniform(-0.2, 0.2) * h))


def piecewise_affine_warp(img, lab, points_src, points_dst):
    """Warp by per-triangle affine maps over Delaunay(points_src): each
    output pixel inside source triangle T maps through T's affine
    src -> dst into input coordinates; the image is sampled with order 1,
    the label with order 0, constant fill 0. The native warp takes at most
    256 triangles (the policy's 4x4 grid makes 18)."""
    from scipy.spatial import Delaunay
    tri = Delaunay(points_src)
    if tri.nsimplex > 256:
        raise ValueError(f"{tri.nsimplex} triangles; the native piecewise "
                         "warp takes at most 256")
    # one pass: triangle lookup, affine and both samplings per pixel
    v = tri.simplices                                   # (ns, 3)
    src = points_src[v]                                 # (ns, 3, 2) (y, x)
    dst = points_dst[v]
    # dst = A @ src + b, solved from each triangle's 3 vertex pairs
    M = np.concatenate([src, np.ones((tri.nsimplex, 3, 1))], axis=2)
    AB = np.linalg.solve(M, dst)                        # (ns, 3, 2)
    aff = np.stack([AB[:, 0, 0], AB[:, 1, 0], AB[:, 2, 0],
                    AB[:, 0, 1], AB[:, 1, 1], AB[:, 2, 1]], axis=1)
    return native_lib.piecewise_warp(
        np.asarray(img, np.float32), np.asarray(lab, np.float32), aff,
        src.reshape(tri.nsimplex, 6))


def _op_piecewise(rng, img, lab):
    """imgaug PiecewiseAffine(scale=(0.008, 0.03)): a 4x4 regular grid of
    control points over [0, h] x [0, w] (borders included), each jittered
    by N(0, scale * (h, w))."""
    h, w = img.shape
    scale = rng.uniform(0.008, 0.03)
    grid = 4
    xg, yg = np.meshgrid(np.linspace(0, w, grid), np.linspace(0, h, grid))
    src = np.stack([yg.ravel(), xg.ravel()], axis=1)
    jitter = rng.normal(0, scale, (grid * grid, 2))
    dst = src + jitter * np.array([h, w])
    return piecewise_affine_warp(img, lab, src, dst)


AUG_OPS: List[_Op] = [
    _Op("Flipud", _op_flipud),
    _Op("Fliplr", _op_fliplr),
    _Op("AdditiveGaussianNoise", _op_noise),
    _Op("GaussianBlur", _op_blur),
    _Op("LinearContrast", _op_contrast),
    _Op("AffineScale", _op_scale),
    _Op("AffineRotate", _op_rotate),
    _Op("AffineShear", _op_shear),
    _Op("PiecewiseAffine", _op_piecewise),
    _Op("AffineTranslate", _op_translate),
]


def augment_seg(rng: np.random.Generator, img: np.ndarray,
                lab: np.ndarray) -> Sample:
    """SomeOf((0, 4)) of ``AUG_OPS`` in random order (reference
    dataset_synapse.py:61-72); float32 image and label out."""
    img = np.asarray(img, np.float32)
    lab = np.asarray(lab, np.float32)
    n = rng.integers(0, 5)
    picks = rng.choice(len(AUG_OPS), size=n, replace=False)
    for i in picks:  # rng.choice's order is already random
        img, lab = AUG_OPS[i].fn(rng, img, lab)
    return img, lab.astype(np.float32)
