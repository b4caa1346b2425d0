"""Bilinear grid sampling (``align_corners=False``, border clamp), NHWC.

Counterpart of ``ceigm_unet_tpu/ops/grid_sample.py``:
:func:`grid_sample_bilinear` is the plain single-grid op and
:func:`dysample_grid_sample` the grouped DySample op (one grid per group of
consecutive channels). For CUDA tensors the latter launches
``csrc/grid_sample.cu``, which computes the exact op; for CPU tensors it runs
:func:`dysample_grid_sample_ref`.
"""
from __future__ import annotations

import torch

from ceigm_unet_tpu_torch.ops import _build


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), grid (B, Ho, Wo, 2) normalised (x, y) -> (B, Ho, Wo,
    C); interpolation in x's dtype, as the JAX op."""
    B, H, W, C = x.shape
    gx = (grid[..., 0].float() + 1.0) * W / 2.0 - 0.5
    gy = (grid[..., 1].float() + 1.0) * H / 2.0 - 0.5
    gx = gx.clamp(0.0, W - 1.0)
    gy = gy.clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx = (gx - x0)[..., None].to(x.dtype)
    wy = (gy - y0)[..., None].to(x.dtype)
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(max=W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(max=H - 1)
    flat = x.reshape(B, H * W, C)

    def take(yi, xi):
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yi.shape, C)

    top = take(y0i, x0i) * (1 - wx) + take(y0i, x1i) * wx
    bot = take(y1i, x0i) * (1 - wx) + take(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def dysample_grid_sample_ref(x: torch.Tensor,
                             grid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dysample_grid_sample`: regroup the channels
    and sample each group with its own grid."""
    B, H, W, C = x.shape
    Ho, Wo, g = grid.shape[1:4]
    cg = C // g
    xg = x.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(
        B * g, H, W, cg)
    gg = grid.permute(0, 3, 1, 2, 4).reshape(B * g, Ho, Wo, 2)
    out = grid_sample_bilinear(xg, gg)
    return out.reshape(B, g, Ho, Wo, cg).permute(0, 2, 3, 1, 4).reshape(
        B, Ho, Wo, C)


def dysample_grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), grid (B, Ho, Wo, g, 2): channel c is sampled with
    grid[..., c // (C // g), :]. Returns (B, Ho, Wo, C) in x's dtype."""
    B, H, W, C = x.shape
    if grid.dim() != 5 or grid.shape[0] != B or grid.shape[-1] != 2 \
            or C % grid.shape[3] != 0:
        raise ValueError(f"dysample_grid_sample: x {tuple(x.shape)} grid "
                         f"{tuple(grid.shape)}")
    if x.device.type == "cpu":
        return dysample_grid_sample_ref(x, grid)
    if x.device.type != "cuda":
        raise ValueError(f"dysample_grid_sample: no kernel for {x.device}")
    Ho, Wo, g = grid.shape[1:4]
    xc = x.contiguous()
    gf = grid.to(dtype=torch.float32).contiguous()
    _build.check_cuda(xc, gf)
    out = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    p = _build.ptr
    _build.launch("dysample_grid_sample", p(xc), p(gf), p(out), B, H, W, C,
                  Ho, Wo, g, _build.dtype_code(x))
    return out
