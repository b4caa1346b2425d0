"""Shared building blocks, channel-last (NHWC) throughout.

Counterpart of ``ceigm_unet_tpu/models/layers.py``. Parameters stay fp32 and
keep the reference torch modules' names and layouts; each op casts them to
its input's dtype, so the input's dtype is the compute dtype, as with flax's
``dtype=`` (LayerNorm and BatchNorm compute in fp32 and return the input's
dtype).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ceigm_unet_tpu_torch.ops.activations import gelu
from ceigm_unet_tpu_torch.ops.ffn import custom_ffn_fused, inception_composite
from ceigm_unet_tpu_torch.parallel import mesh, sp_context, sp_ops
from ceigm_unet_tpu_torch.utils.spans import span


class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors (cuDNN sees a channels_last NCHW view).
    Under the H-sharded context (``parallel/sp_context.py``) a conv that
    reads across rows takes its rows from a halo (``sp_ops.conv2d``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        ring = sp_context.ring()
        if ring is not None and self.kernel_size[0] > 1:
            return sp_ops.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                                 self.padding, self.dilation, self.groups,
                                 ring)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the last (channel) axis of NHWC input, with flax's
    semantics (``nn.BatchNorm(momentum=0.9)`` as the JAX package uses it):
    in training, the batch mean and the biased variance over (B, H, W) in
    fp32, and running statistics updated as 0.9 * old + 0.1 * batch with
    that biased variance (torch's own update uses the unbiased one). With
    a data-parallel group active (``parallel/mesh.py``), the batch is the
    global one: the mean and then the variance are summed over the ranks,
    and every rank updates the same running statistics."""

    MOMENTUM = 0.9

    def forward(self, x):
        return self.forward_fp32(x).to(x.dtype)

    def forward_fp32(self, x):
        """The normalised x in fp32 (LGAG adds two of them before it
        rounds to the compute dtype)."""
        xf = x.float()
        if self.training:
            var, mean = (torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
                         if mesh.active_group() is None
                         else _global_var_mean(xf))
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _global_var_mean(xf: torch.Tensor):
    """(biased variance, mean) per channel of (B, H, W, C) ``xf`` over the
    data-parallel group's global batch, two passes as ``torch.var_mean``;
    differentiable."""
    C = xf.shape[-1]
    s = mesh.all_reduce_sum(torch.cat([xf.sum((0, 1, 2)),
                                       xf.new_full((1,), xf.numel() // C)]))
    mean = s[:C] / s[C]
    var = mesh.all_reduce_sum(((xf - mean) ** 2).sum((0, 1, 2))) / s[C]
    return var, mean


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval. In training the
    keep masks (one per sample, kept with probability 1 - rate, kept
    samples scaled by 1/keep) come from the ``torch.Generator`` passed to
    ``forward``. There is no draw from torch's global generator. With a
    data-parallel group active, the masks of the global batch are drawn and
    this rank keeps its rows (``mesh.global_rows``)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator "
                             "(pass generator=)")
        keep = 1.0 - self.rate
        total, first = mesh.global_rows(x.shape[0])
        shape = (total,) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=generator.device
                          )[first:first + x.shape[0]] < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def dw_conv(dim: int, kernel: Union[int, Tuple[int, int]] = 3,
            bias: bool = True) -> Conv2d:
    """Depthwise conv (groups == channels), ``kernel`` k or (kh, kw), with
    torch padding k//2 per axis ('SAME' for odd kernels)."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return Conv2d(dim, dim, (kh, kw), padding=(kh // 2, kw // 2),
                  groups=dim, bias=bias)


class DwConv(nn.Module):
    """Depthwise 3x3 with bias (reference DWConv: key ``dwconv.dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = dw_conv(dim, 3)

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
        """(7, 7, 1, C) composite kernel and (C,) bias, flax layout; inside
        the span ``derive.ffn``."""
        fl = lambda m: m.weight.permute(2, 3, 1, 0)
        with span("derive.ffn"):
            return inception_composite(
                self.dim, self.g, fl(self.dwconv_3x3), fl(self.dwconv_5x5),
                fl(self.dwconv_7x7), self.dwconv_3x3.bias,
                self.dwconv_5x5.bias, self.dwconv_7x7.bias, dtype)


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
        ring = sp_context.ring()
        if ring is not None:
            # a border q is gelu(dwb) + ..., not zero: the op runs on 4 rows
            # of x each side (1 for the dw3, 3 for the 7x7) with the rows
            # beyond the image cut, so its own padding stands there
            return sp_ops.rows_with_halo(self._fused, x, ring, 4, cut=True)
        return self._fused(x)

    def _fused(self, x):
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
    'bilinear' == F.interpolate(align_corners=False) when upsampling); on
    the image's rows under the H-sharded context."""
    ring = sp_context.ring()
    if ring is not None:
        return sp_ops.upsample_rows(x, ring, scale)
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
