"""Shared building blocks, channel-last (NHWC) throughout.

Counterpart of ``ceigm_unet_tpu/models/layers.py``. Parameters stay fp32 and
keep the reference torch modules' names and layouts; each op casts them to
its input's dtype, so the input's dtype is the compute dtype, as with flax's
``dtype=`` (LayerNorm and BatchNorm compute in fp32 and return the input's
dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ceigm_unet_tpu_torch.ops.activations import gelu
from ceigm_unet_tpu_torch.ops.ffn import custom_ffn_fused, inception_composite


class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors (cuDNN sees a channels_last NCHW view)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm over the last (channel) axis of NHWC input."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "the port runs inference only: call model.eval()")
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return y.to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DwConv(nn.Module):
    """Depthwise 3x3 with bias (reference DWConv: key ``dwconv.dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class Pvt2Ffn(nn.Module):
    """fc1 -> depthwise 3x3 -> GELU -> fc2 (reference PVT2FFN)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DwConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class InceptionDWConvMultiScale(nn.Module):
    """Residual multi-scale depthwise mixer: channels split (C-3g | g | g |
    g), g = C/8; identity on the first slice, depthwise 3x3/5x5/7x7 on the
    rest; the input added back. Holds the branch parameters; CustomFfn
    evaluates the mixer as the one composite 7x7 of :meth:`composite`."""

    def __init__(self, dim: int):
        super().__init__()
        g = int(dim * 0.125)
        self.dim, self.g = dim, g
        self.dwconv_3x3 = Conv2d(g, g, 3, padding=1, groups=g)
        self.dwconv_5x5 = Conv2d(g, g, 5, padding=2, groups=g)
        self.dwconv_7x7 = Conv2d(g, g, 7, padding=3, groups=g)

    def composite(self, dtype: torch.dtype):
        """(7, 7, 1, C) composite kernel and (C,) bias, flax layout."""
        fl = lambda m: m.weight.permute(2, 3, 1, 0)
        return inception_composite(
            self.dim, self.g, fl(self.dwconv_3x3), fl(self.dwconv_5x5),
            fl(self.dwconv_7x7), self.dwconv_3x3.bias, self.dwconv_5x5.bias,
            self.dwconv_7x7.bias, dtype)


class CustomFfn(nn.Module):
    """fc1 -> dw3x3 -> GELU -> InceptionDWConvMultiScale -> fc2 (reference
    custom_ffn), through the fused op :func:`custom_ffn_fused`."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DwConv(hidden)
        self.custom = InceptionDWConvMultiScale(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        inck, incb = self.custom.composite(torch.float32)
        y = custom_ffn_fused(
            x.reshape(B, H * W, C), self.fc1.weight.t(), self.fc1.bias,
            self.dwconv.dwconv.weight.permute(2, 3, 1, 0),
            self.dwconv.dwconv.bias, inck, incb, self.fc2.weight.t(),
            self.fc2.bias, H, W, 3 * self.custom.g)
        return y.reshape(B, H, W, C)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel-last channel shuffle (the identity at groups == C, which is
    how the decoder calls it)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(-1, -2).reshape(
        b, h, w, c)


def bilinear_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upsample with half-pixel centres (jax.image.resize
    'bilinear' == F.interpolate(align_corners=False) when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
