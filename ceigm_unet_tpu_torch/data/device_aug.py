"""On-device augmentation: the host policy as batched torch ops on the card.

Counterpart of ``ceigm_unet_tpu/data/device_aug.py`` (which ran as XLA, with
no Pallas kernel; here plain torch indexing and ``conv2d``):

- the op count is exactly SomeOf((0, 4)): per sample n ~ Uniform{0..4} and
  a uniform size-n subset of the host tier's 10 ops (``data/augment.py``
  ``AUG_OPS``), :func:`someof_active`;
- every geometric op (flips, scale, rotate, shear, translate, the
  piecewise mesh warp) composes into one coordinate map per sample, applied
  together with the zoom to the patch size as one bilinear (image) /
  nearest (label) gather, so a 512x512 slice is augmented and resized in
  one pass. The piecewise warp's source triangulation is fixed (a 4x4
  linspace grid), so the triangle of each output pixel is found once per
  shape on the host; only the per-sample jitter reaches the card;
- the photometric ops (Gaussian noise, Gaussian blur, linear contrast)
  are masked elementwise ops and a separable ``conv2d``;
- geometric before photometric, in one fixed order: the one departure from
  the host tier's random order (``docs/PARITY.md``).

Sampling the parameters (:func:`sample_params`) is apart from applying
them (:func:`apply_params`). Every draw is one tensor of shape (B, ...)
from one ``torch.Generator``, so a batch's augmentation depends only on
the generator's seed and B; the train step seeds it per step from
(seed, step) (:func:`step_generator`). ``jax.random`` cannot be matched
bit for bit; the tests hold :func:`apply_params` against the JAX package
with the parameters injected.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Op universe, in data/augment.py AUG_OPS's order:
# 0 Flipud, 1 Fliplr, 2 AdditiveGaussianNoise, 3 GaussianBlur,
# 4 LinearContrast, 5 AffineScale, 6 AffineRotate, 7 AffineShear,
# 8 PiecewiseAffine, 9 AffineTranslate
N_OPS = 10
_PW_GRID = 4  # imgaug PiecewiseAffine's nb_rows / nb_cols


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2,
                                                                np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def someof_active(gen: torch.Generator, batch: int, n_ops: int = N_OPS,
                  n_max: int = 4, device="cpu") -> torch.Tensor:
    """imgaug SomeOf((0, n_max)) membership, (batch, n_ops) bool: n ~
    Uniform{0..n_max}, then the ops whose rank in a uniformly random
    permutation is below n (a uniform size-n subset, as
    ``rng.choice(n_ops, size=n, replace=False)`` in the host tier)."""
    n = torch.randint(0, n_max + 1, (batch, 1), generator=gen, device=device)
    keys = torch.rand((batch, n_ops), generator=gen, device=device)
    rank = torch.argsort(torch.argsort(keys, dim=1), dim=1)
    return rank < n


def _affine_params(gen, active, device):
    """Per-sample affine parameters in the reference's ranges, gated by the
    membership mask (an inactive op takes its identity value)."""
    B = active.shape[0]
    flips = torch.rand((B, 2), generator=gen, device=device) < 0.5
    flipud = active[:, 0] & flips[:, 0]
    fliplr = active[:, 1] & flips[:, 1]
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)
    scale = torch.where(active[:, 5, None],
                        _uniform(gen, (B, 2), 0.5, 2.0, device), one)
    rot = torch.where(active[:, 6], _uniform(gen, (B,), -40.0, 40.0, device),
                      zero)
    shear = torch.where(active[:, 7],
                        _uniform(gen, (B,), -16.0, 16.0, device), zero)
    trans = torch.where(active[:, 9, None],
                        _uniform(gen, (B, 2), -0.2, 0.2, device), zero)
    return flipud, fliplr, scale, rot, shear, trans


def sample_params(gen: torch.Generator, batch: int, h: int, w: int,
                  out_size: int, device="cpu") -> Dict[str, torch.Tensor]:
    """All random draws of one batch (see :func:`apply_params`)."""
    active = someof_active(gen, batch, device=device)
    flipud, fliplr, scale, rot, shear, trans = _affine_params(gen, active,
                                                              device)
    pscale = _uniform(gen, (batch, 1), 0.008, 0.03, device)
    jitter = torch.randn((batch, _PW_GRID * _PW_GRID, 2), generator=gen,
                         device=device)
    jitter = torch.stack([jitter[..., 0] * pscale * h,
                          jitter[..., 1] * pscale * w], dim=-1)
    jitter = torch.where(active[:, 8, None, None], jitter, 0.0)
    return dict(active=active, flipud=flipud, fliplr=fliplr, scale=scale,
                rot=rot, shear=shear, trans=trans, jitter=jitter,
                alpha=_uniform(gen, (batch,), 0.5, 1.5, device),
                noise=torch.randn((batch, out_size, out_size), generator=gen,
                                  device=device))


def _mm(a, b):
    """3x3 product of matrices held as nested lists of (B,) tensors, each
    entry summed over k in order."""
    return [[(a[i][0] * b[0][j] + a[i][1] * b[1][j]) + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _cos_sin(x):
    """cos and sin of float32 ``x`` rounded from float64: the same float32
    on the card and the CPU (float32 cos/sin differ by an ulp between the
    two libraries)."""
    x = x.double()
    return torch.cos(x).float(), torch.sin(x).float()


def _compose_matrix(flipud, fliplr, scale, rot_deg, shear_deg, trans_frac,
                    h, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward affine per sample in (x, y), center-origin: Shear, Rot,
    Trans, Scale (the host tier's composition), the flips folded into the
    scale's signs. Returns (lin (B, 2, 2), offset (B, 2)). Elementwise
    float32 ops only (no library matrix product, whose sums differ between
    devices), so the card and the CPU give the same bits."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cr, sr = _cos_sin(torch.deg2rad(rot_deg))
    csh, ssh = _cos_sin(torch.deg2rad(shear_deg))
    sx = scale[:, 0] * torch.where(fliplr, -1.0, 1.0)
    sy = scale[:, 1] * torch.where(flipud, -1.0, 1.0)
    one, zero = torch.ones_like(cr), torch.zeros_like(cr)
    S = [[sx, zero, zero], [zero, sy, zero], [zero, zero, one]]
    T = [[one, zero, trans_frac[:, 0] * w], [zero, one, trans_frac[:, 1] * h],
         [zero, zero, one]]
    R = [[cr, -sr, zero], [sr, cr, zero], [zero, zero, one]]
    Sh = [[one, -ssh, zero], [zero, csh, zero], [zero, zero, one]]
    C = [[one, zero, one * cx], [zero, one, one * cy], [zero, zero, one]]
    Ci = [[one, zero, one * -cx], [zero, one, one * -cy], [zero, zero, one]]
    M = _mm(_mm(_mm(_mm(_mm(C, Sh), R), T), S), Ci)
    lin = torch.stack([torch.stack(M[0][:2], -1), torch.stack(M[1][:2], -1)],
                      -2)
    return lin, torch.stack([M[0][2], M[1][2]], -1)


def _inv2(lin):
    """Inverse of (B, 2, 2) matrices by the adjugate (elementwise ops)."""
    a, b, c, d = lin[:, 0, 0], lin[:, 0, 1], lin[:, 1, 0], lin[:, 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d / det, -b / det], -1),
                        torch.stack([-c / det, a / det], -1)], -2)


@functools.lru_cache(maxsize=16)
def _pw_statics(h: int, w: int, out_h: int, out_w: int, device: str):
    """The piecewise warp's fixed part for an (h, w) slice sampled on the
    (out_h, out_w) zoom grid: the 4x4 control grid's Delaunay triangles
    (T, 3), the inverse vertex matrices (T, 3, 3) and each query pixel's
    triangle (out_h, out_w), as tensors on ``device``."""
    from scipy.spatial import Delaunay
    xg, yg = np.meshgrid(np.linspace(0, w, _PW_GRID),
                         np.linspace(0, h, _PW_GRID))
    src = np.stack([yg.ravel(), xg.ravel()], axis=1)      # (16, 2) (y, x)
    tri = Delaunay(src)
    qy = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    qx = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    gy, gx = np.meshgrid(qy, qx, indexing="ij")
    sid = tri.find_simplex(np.stack([gy.ravel(), gx.ravel()], axis=1),
                           tol=1e-8)
    if (sid < 0).any():
        raise ValueError(f"the zoom grid of {h}x{w} -> {out_h}x{out_w} "
                         "leaves the control grid's hull")
    M = np.concatenate([src[tri.simplices],
                        np.ones((tri.nsimplex, 3, 1))], axis=2)  # (T, 3, 3)
    Minv = np.linalg.inv(M)
    return (torch.from_numpy(tri.simplices.astype(np.int64)).to(device),
            torch.from_numpy(Minv.astype(np.float32)).to(device),
            torch.from_numpy(sid.reshape(out_h, out_w)).to(device))


def _piecewise_map(jitter, gy, gx, h, w):
    """imgaug PiecewiseAffine as a coordinate map: each query pixel goes
    through its source triangle's affine for the control grid moved by
    ``jitter`` (B, 16, 2) (zero where the op is inactive). Computed as a
    displacement (coords = pix + pix_h @ Minv @ jitter[verts]), so zero
    jitter is exactly the identity, with elementwise sums in a fixed order
    (the same bits on the card and the CPU). Returns (qy, qx), each
    (B, oh, ow)."""
    simplices, Minv, sid = _pw_statics(h, w, gy.shape[0], gy.shape[1],
                                       str(gy.device))
    J = jitter[:, simplices]                         # (B, T, 3, 2)
    m = Minv[None, :, :, :, None]                    # (1, T, 3, 3, 1)
    J = J[:, :, None]                                # (B, T, 1, 3, 2)
    D = (m[:, :, :, 0] * J[:, :, :, 0] + m[:, :, :, 1] * J[:, :, :, 1]) \
        + m[:, :, :, 2] * J[:, :, :, 2]              # (B, T, 3, 2)
    Dp = D[:, sid]                                   # (B, oh, ow, 3, 2)
    disp = (gy[..., None] * Dp[..., 0, :] + gx[..., None] * Dp[..., 1, :]) \
        + Dp[..., 2, :]

    def snap(c, hi):
        # round-off at the hull's edges: keep boundary pixels in range as
        # the host tier's snap does
        c = torch.where((c < 0) & (c > -1e-4), 0.0, c)
        return torch.where((c > hi) & (c < hi + 1e-4), float(hi), c)

    return snap(gy + disp[..., 0], h - 1), snap(gx + disp[..., 1], w - 1)


def _take(im, yi, xi):
    """im (B, H, W) at integer (yi, xi) (B, oh, ow); 0 outside (imgaug's
    cval)."""
    B, H, W = im.shape
    inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    v = torch.gather(im.reshape(B, H * W), 1, idx.reshape(B, -1))
    return torch.where(inside, v.reshape(yi.shape), 0)


def _bilinear(im, sy, sx):
    """Bilinear sample of im (B, H, W) at (sy, sx) (B, oh, ow); each corner
    outside the slice counts as 0."""
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    x0i, y0i = x0.long(), y0.long()
    return (_take(im, y0i, x0i) * (1 - wx) * (1 - wy)
            + _take(im, y0i, x0i + 1) * wx * (1 - wy)
            + _take(im, y0i + 1, x0i) * (1 - wx) * wy
            + _take(im, y0i + 1, x0i + 1) * wx * wy)


def _nearest(im, sy, sx):
    """Nearest sample (round half to even, as ``jnp.round``); 0 outside."""
    return _take(im, torch.round(sy).long(), torch.round(sx).long())


def _gaussian_blur(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of (B, h, w), truncated at 4 sigma, with
    'symmetric' padding (scipy.ndimage.gaussian_filter's default 'reflect'
    mode, the host tier's blur)."""
    radius = int(4 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)

    def sym(n):
        i = torch.arange(-radius, n + radius, device=img.device)
        return torch.where(i < 0, -i - 1, torch.where(i >= n, 2 * n - 1 - i,
                                                      i))

    h, w = img.shape[-2:]
    x = img[:, None][:, :, sym(h)]
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.conv2d(x[..., sym(w)], k.view(1, 1, 1, -1))
    return x[:, 0]


def apply_params(params: Dict[str, torch.Tensor], images: torch.Tensor,
                 labels: torch.Tensor, out_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images / labels (B, H, W) -> augmented and zoomed (B, out, out):
    float32 images, labels in their own dtype."""
    B, H, W = images.shape
    dev = images.device
    ys = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) \
        * (H / out_size) - 0.5
    xs = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) \
        * (W / out_size) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")   # output grid, input px
    p = params
    lin, off = _compose_matrix(p["flipud"], p["fliplr"], p["scale"],
                               p["rot"], p["shear"], p["trans"], H, W)
    inv = _inv2(lin)[:, :, :, None, None]
    # the piecewise warp first (on the fixed query grid), then the inverse
    # of the composed affine
    qy, qx = _piecewise_map(p["jitter"], gy, gx, H, W)
    x, y = qx - off[:, 0, None, None], qy - off[:, 1, None, None]
    sx = inv[:, 0, 0] * x + inv[:, 0, 1] * y
    sy = inv[:, 1, 0] * x + inv[:, 1, 1] * y
    img = _bilinear(images.float(), sy, sx)
    lab = _nearest(labels, sy, sx)

    act = p["active"][:, :, None, None]
    img = torch.where(act[:, 2], img + 0.005 * 255 * p["noise"], img)
    img = torch.where(act[:, 3], _gaussian_blur(img, 1.0), img)
    pivot = 0.5
    img = torch.where(act[:, 4],
                      (img - pivot) * p["alpha"][:, None, None] + pivot, img)
    return img, lab


def device_augment(gen: torch.Generator, images: torch.Tensor,
                   labels: torch.Tensor, out_size: int = 224
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images / labels (B, H, W) on one device -> augmented and zoomed
    (B, out, out), the parameters drawn from ``gen`` (a generator on that
    device)."""
    B, H, W = images.shape
    return apply_params(sample_params(gen, B, H, W, out_size,
                                      images.device),
                        images, labels, out_size)
