"""Depthwise 3x3 'SAME' convolution plus bias over NHWC, with its transpose.

Counterpart of ``ceigm_unet_tpu/ops/quad_scan_bl.py`` ``dwconv_bl``, the
quad block's depthwise conv (``_dwconv_bl_kernel``): out = bias + the 9
shifted taps, accumulated in fp32 and written in x's dtype. Weights are
torch's (C, 1, 3, 3) depthwise layout (flax's (3, 3, 1, C) kernel
``k[ky, kx, 0, c]`` is ``weight[c, 0, ky, kx]``).

:func:`dwconv3x3` is the autograd op :class:`DwConv3x3`. For CUDA tensors
its forward launches ``csrc/dwconv3.cu``, which reads x in place through
its strides (the quad block hands in a channel slice of its in-projection
output, row stride 2*C); its backward runs the same kernel in flip mode
(:func:`dwconv3x3_flip`: the taps turned by 180 degrees, no bias, the exact
transpose) for dx, and the weight and bias gradients as fp32 tap-shifted
reductions in PyTorch, as ``_dwconv_bl_bwd`` does in XLA. For CPU tensors
both directions run the plain version :func:`dwconv3x3_ref`.

In the JAX package the kernel is reached only with ``CEIGM_BLDW`` other
than ``xla``, inside the batch-last quad sandwich, which runs at batch 64
and above. The port's ``dwconv="kernel"`` route (``QuadGroupSS2D``) applies
at every batch, over the same function, in the block's NHWC layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops import _build


def _taps(x: torch.Tensor):
    """(ky, kx, the fp32 (B, H, W, C) window of x that tap (ky, kx)
    multiplies), zeros outside the image."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return [(ky, kx, xp[:, ky:ky + H, kx:kx + W])
            for ky in range(3) for kx in range(3)]


def dwconv3x3_ref(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor = None, flip: bool = False):
    """Plain version of the kernel (``_dw_body``): fp32 sum from the bias
    (zero in flip mode) over the 9 taps in row-major order; ``flip`` takes
    tap (2-ky, 2-kx) at shift (ky, kx). Returns x's dtype."""
    w = weight.float().reshape(-1, 3, 3)
    acc = (torch.zeros_like(x, dtype=torch.float32) if flip
           else bias.float().expand(x.shape).clone())
    for ky, kx, v in _taps(x):
        acc = acc + (w[:, 2 - ky, 2 - kx] if flip else w[:, ky, kx]) * v
    return acc.to(x.dtype)


def _launch(x, weight, bias, flip: bool):
    B, H, W, C = x.shape
    if x.stride(3) != 1:
        x = x.contiguous()
    # torch's (C, 1, 3, 3) taps as stored: the kernel reads them as (C, 9),
    # so an fp32 weight is passed with no copy
    wf = weight.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    _build.check_cuda(x, wf)
    p = _build.ptr
    if flip:
        _build.launch("dwconv3x3_flip", p(x), p(wf), p(out), *x.stride()[:3],
                      B, H, W, C, _build.dtype_code(x))
    else:
        bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
        _build.launch("dwconv3x3", p(x), p(wf), p(bf), p(out),
                      *x.stride()[:3], B, H, W, C, _build.dtype_code(x))
    return out


def _dwconv(x, weight, bias, flip: bool):
    if x.device.type == "cpu":
        return dwconv3x3_ref(x, weight, bias, flip)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv3x3: no kernel for {x.device}")
    return _launch(x, weight, bias, flip)


class DwConv3x3(torch.autograd.Function):
    """Autograd op of :func:`dwconv3x3`: dx by the flip mode, dweight and
    dbias by fp32 tap-shifted reductions (``_dwconv_bl_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return _dwconv(x, weight, bias, flip=False)

    @staticmethod
    def backward(ctx, go):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dwconv(go, weight, None, flip=True).to(x.dtype)
        gf = go.float()
        if ctx.needs_input_grad[1]:
            dw = torch.stack([(v * gf).sum((0, 1, 2)) for _, _, v in
                              _taps(x)], dim=1)             # (C, 9)
            dw = dw.reshape(weight.shape).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = gf.sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def _check(what: str, x: torch.Tensor, weight: torch.Tensor) -> None:
    C = x.shape[-1] if x.dim() == 4 else -1
    if C < 0 or weight.shape != (C, 1, 3, 3):
        raise ValueError(f"{what}: x {tuple(x.shape)} (B, H, W, C), weight "
                         f"{tuple(weight.shape)} (C, 1, 3, 3)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {x.device}")


def dwconv3x3(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), any strides; weight (C, 1, 3, 3); bias (C,).
    Returns (B, H, W, C) contiguous in x's dtype, differentiable in all
    three."""
    _check("dwconv3x3", x, weight)
    if bias.shape != (x.shape[-1],):
        raise ValueError(f"dwconv3x3: bias {tuple(bias.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return DwConv3x3.apply(x, weight, bias)
    # nothing to differentiate: the kernel alone, without the autograd
    # op's host time (at 7x7 the host's time per call exceeds the kernel's)
    return _dwconv(x, weight, bias, flip=False)


def dwconv3x3_flip(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`dwconv3x3` (no bias) applied to g (B, H, W,
    C): what the backward runs for dx. No backward of its own."""
    _check("dwconv3x3_flip", g, weight)
    if g.device.type == "cuda":
        _build.check_no_grad("dwconv3x3_flip", g, weight)
    return _dwconv(g, weight, None, flip=True)
