"""Bilinear grid sampling (``align_corners=False``, border clamp), NHWC.

Counterpart of ``ceigm_unet_tpu/ops/grid_sample.py``:
:func:`grid_sample_bilinear` is the plain single-grid op and
:func:`dysample_grid_sample` the grouped DySample op (one grid per group of
consecutive channels). For CUDA tensors the latter launches
``csrc/grid_sample.cu``, which computes the exact op; for CPU tensors it runs
:func:`dysample_grid_sample_ref`. It is differentiable through
:class:`DySampleGridSample`, whose backward is the vector-Jacobian product
of the plain version (the JAX package's ``_gs_banded_groups_bwd``): a
coordinate clamped at the border gets a zero gradient.

:func:`grid_sample_bilinear_fused` is the single-grid op for any output
size (the JAX package's entry of the same name, whose TPU kernels are
``_gs_banded_impl`` for 2x outputs and ``_gs_fused_impl`` otherwise): the
same device code with one group, exact where the banded TPU kernel clamps
to its band. :func:`dysample_grid_sample_pergroup` is DySample's per-group
route through it (``_dysample_ref``: regroup, sample, regroup back), taken
when the model is built with ``dysample_grouped=False``.
"""
from __future__ import annotations

import torch

from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.recompute import recompute_vjp


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


def _per_group(sample, x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Regroup (B, H, W, C) into (B*g, H, W, C/g), sample each group with
    its own grid by ``sample`` and regroup back (``_dysample_ref``)."""
    B, H, W, C = x.shape
    Ho, Wo, g = grid.shape[1:4]
    cg = C // g
    xg = x.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(
        B * g, H, W, cg)
    gg = grid.permute(0, 3, 1, 2, 4).reshape(B * g, Ho, Wo, 2)
    out = sample(xg, gg)
    return out.reshape(B, g, Ho, Wo, cg).permute(0, 2, 3, 1, 4).reshape(
        B, Ho, Wo, C)


def dysample_grid_sample_ref(x: torch.Tensor,
                             grid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dysample_grid_sample`: regroup the channels
    and sample each group with its own grid."""
    return _per_group(grid_sample_bilinear, x, grid)


def _gs_launch(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    Ho, Wo = grid.shape[1:3]
    xc = x.contiguous()
    gf = grid.to(dtype=torch.float32).contiguous()
    _build.check_cuda(xc, gf)
    out = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    p = _build.ptr
    _build.launch("grid_sample_bilinear", p(xc), p(gf), p(out), B, H, W, C,
                  Ho, Wo, _build.dtype_code(x))
    return out


class GridSampleBilinear(torch.autograd.Function):
    """Autograd op of :func:`grid_sample_bilinear_fused`; its backward is
    the vector-Jacobian product of the plain version, as ``_gs_fused_bwd``
    and ``_gs_banded_bwd`` differentiate the exact mm form."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x, grid)
        if x.device.type == "cpu":
            return grid_sample_bilinear(x, grid)
        return _gs_launch(x, grid)

    @staticmethod
    def backward(ctx, go):
        return recompute_vjp(grid_sample_bilinear, ctx.saved_tensors,
                             ctx.needs_input_grad, go)


def grid_sample_bilinear_fused(x: torch.Tensor,
                               grid: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), grid (B, Ho, Wo, 2) -> (B, Ho, Wo, C) in x's dtype,
    any output size: ``csrc/grid_sample.cu`` for CUDA tensors,
    :func:`grid_sample_bilinear` for CPU tensors; differentiable."""
    if x.dim() != 4 or grid.dim() != 4 or grid.shape[0] != x.shape[0] \
            or grid.shape[-1] != 2:
        raise ValueError(f"grid_sample_bilinear_fused: x {tuple(x.shape)} "
                         f"grid {tuple(grid.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_sample_bilinear_fused: no kernel for "
                         f"{x.device}")
    return GridSampleBilinear.apply(x, grid)


def dysample_grid_sample_pergroup(x: torch.Tensor,
                                  grid: torch.Tensor) -> torch.Tensor:
    """DySample's per-group route (the JAX package's ``_dysample_ref``, its
    path with ``CEIGM_GS_GROUP=0``): the same function as
    :func:`dysample_grid_sample`, with the channel regroup done by two
    permute copies around :func:`grid_sample_bilinear_fused`."""
    B, H, W, C = x.shape
    if grid.dim() != 5 or grid.shape[0] != B or grid.shape[-1] != 2 \
            or C % grid.shape[3] != 0:
        raise ValueError(f"dysample_grid_sample_pergroup: x "
                         f"{tuple(x.shape)} grid {tuple(grid.shape)}")
    return _per_group(grid_sample_bilinear_fused, x, grid)


def _dysample_launch(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
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


class DySampleGridSample(torch.autograd.Function):
    """Autograd op of :func:`dysample_grid_sample`."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x, grid)
        if x.device.type == "cpu":
            return dysample_grid_sample_ref(x, grid)
        return _dysample_launch(x, grid)

    @staticmethod
    def backward(ctx, go):
        return recompute_vjp(dysample_grid_sample_ref, ctx.saved_tensors,
                             ctx.needs_input_grad, go)


def dysample_grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), grid (B, Ho, Wo, g, 2): channel c is sampled with
    grid[..., c // (C // g), :]. Returns (B, Ho, Wo, C) in x's dtype."""
    B, H, W, C = x.shape
    if grid.dim() != 5 or grid.shape[0] != B or grid.shape[-1] != 2 \
            or C % grid.shape[3] != 0:
        raise ValueError(f"dysample_grid_sample: x {tuple(x.shape)} grid "
                         f"{tuple(grid.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dysample_grid_sample: no kernel for {x.device}")
    return DySampleGridSample.apply(x, grid)
