"""EMCAD decoder (NHWC).

Counterpart of ``ceigm_unet_tpu/models/emcad.py``, with its dataflow and
reference quirks: per scale (coarse -> fine) SplitChannelsOddEven ->
ParallelAttentionFusion -> DySample 2x (+ EUCB pointwise) -> LGAG gate on
the skip (both gate paths read g) -> add -> Front; then a 1x1 head and a 4x
bilinear upsample, with logits in the compute dtype. Module names follow
the reference torch decoder. In training the Front blocks' stochastic depth
runs at linspace(drop_path_rate, 0, 7) and BatchNorm uses batch statistics.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ceigm_unet_tpu_torch.models.groupmamba import BlockMamba
from ceigm_unet_tpu_torch.models.layers import (BatchNorm2d, Conv2d,
                                                bilinear_upsample,
                                                channel_shuffle)
from ceigm_unet_tpu_torch.ops.grid_sample import (
    dysample_grid_sample, dysample_grid_sample_pergroup)
from ceigm_unet_tpu_torch.ops.tapconv import lgag_fold, lgag_gate
from ceigm_unet_tpu_torch.parallel import sp_context, sp_ops
from ceigm_unet_tpu_torch.utils.spans import span


def _bn_dict(bn: BatchNorm2d):
    return dict(scale=bn.weight, bias=bn.bias, mean=bn.running_mean,
                var=bn.running_var)


class LGAG(nn.Module):
    """Large-kernel grouped attention gate: six grouped 2-in/1-out convs
    (k 1/3/5, both branches read g), one shared BN applied to both branch
    sums, ReLU, psi 1x1 conv + BN, sigmoid, x * psi. Eval runs the fused op
    :func:`lgag_gate` on the folded weights; training runs the unfolded
    form with batch statistics, updating the shared BN's running statistics
    twice per forward (g branch, then x branch), as the JAX package does."""

    def __init__(self, f_int: int):
        super().__init__()
        for a in ("g", "x"):
            for k in (1, 3, 5):
                self.add_module(f"W_{a}_{k}", Conv2d(
                    2 * f_int, f_int, k, padding=k // 2, groups=f_int))
        self.bn = BatchNorm2d(f_int)
        self.psi = nn.Sequential(Conv2d(f_int, 1, 1), BatchNorm2d(1))

    def folded(self):
        """The eval-mode fold of :func:`lgag_fold`: weights only; inside
        the span ``derive.lgag``."""
        with span("derive.lgag"):
            convs = [(m.weight.permute(2, 3, 1, 0), m.bias) for m in (
                self.W_g_1, self.W_g_3, self.W_g_5, self.W_x_1, self.W_x_3,
                self.W_x_5)]
            return lgag_fold(convs, _bn_dict(self.bn),
                             self.psi[0].weight.permute(2, 3, 1, 0),
                             self.psi[0].bias, _bn_dict(self.psi[1]))

    def forward(self, g, x):
        if not self.training:
            ring = sp_context.ring()
            if ring is not None:
                # the k 1/3/5 convs on g reach 2 rows; x is read pointwise
                return sp_ops.rows_with_halo(
                    lambda gh, xh: lgag_gate(gh, xh, *self.folded()), g,
                    ring, 2, pointwise=(x,))
            return lgag_gate(g, x, *self.folded())
        gs = self.bn.forward_fp32(self.W_g_1(g) + self.W_g_3(g)
                                  + self.W_g_5(g))
        xs = self.bn.forward_fp32(self.W_x_1(g) + self.W_x_3(g)
                                  + self.W_x_5(g))
        psi = self.psi[0](torch.relu(gs + xs).to(g.dtype))
        return x * torch.sigmoid(self.psi[1].forward_fp32(psi)).to(x.dtype)


class MultiScaleCAB(nn.Module):
    """Channel attention from avg/max/min pools: sigmoid(fc(...) + x)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        rc = self.reduced_channels(channels, ratio)
        self.conv1 = Conv2d(channels, rc, 1, bias=False)
        self.conv2_1 = Conv2d(channels, rc, 1, groups=rc, bias=False)
        self.conv2_2 = Conv2d(rc, rc, 1, groups=rc, bias=False)
        self.conv3 = Conv2d(channels, rc, 1, bias=False)
        self.fc = nn.Sequential(Conv2d(3 * rc, channels, 1, bias=False))

    @staticmethod
    def reduced_channels(c: int, ratio: int = 16) -> int:
        factor = max(1, c // ratio // 3)
        while c % factor != 0:
            factor += 1
        return factor

    def forward(self, x):
        ring = sp_context.ring()
        if ring is None:
            avg = x.mean(dim=(1, 2), keepdim=True)
            mx = x.amax(dim=(1, 2), keepdim=True)
            mn = x.amin(dim=(1, 2), keepdim=True)
        else:
            avg, mx, mn = [f(x, ring)[:, None, None] for f in (
                sp_ops.mean_hw, sp_ops.amax_hw, sp_ops.amin_hw)]
        comb = torch.cat([self.conv1(avg), self.conv2_2(self.conv2_1(mx)),
                          self.conv3(mn)], dim=-1)
        return torch.sigmoid(self.fc(comb) + x)


class SAB(nn.Module):
    """Spatial attention: channel mean/max -> conv 3/7/11 sum -> sigmoid."""

    def __init__(self):
        super().__init__()
        for k in (3, 7, 11):
            self.add_module(f"conv{k}", Conv2d(2, 1, k, padding=k // 2,
                                               bias=False))

    def forward(self, x):
        cat = torch.cat([x.mean(-1, keepdim=True), x.amax(-1, keepdim=True)],
                        dim=-1)
        return torch.sigmoid(self.conv3(cat) + self.conv7(cat)
                             + self.conv11(cat))


class ParallelAttentionFusion(nn.Module):
    """Channel attention on x1 and spatial attention on x2, arctan-mixed
    and fused through a learned sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.channel_attention = MultiScaleCAB(channels)
        self.spatial_attention = SAB()
        self.x = nn.Parameter(torch.zeros(1))
        self.final_conv = Conv2d(2 * channels, channels, 1)

    def forward(self, x1, x2):
        ca = self.channel_attention(x1)
        sa = self.spatial_attention(x2)
        ca_w = 0.5 + torch.atan(math.pi * self.x) / math.pi
        fusion = torch.cat([x1 * ca * ca_w.to(x1.dtype),
                            x2 * sa * (1.0 - ca_w).to(x2.dtype)], dim=-1)
        return (x1 + x2) * torch.sigmoid(self.final_conv(fusion))


class SplitChannelsOddEven(nn.Module):
    """Even and odd channels through one shared 1x1 conv (C/2 -> C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.cw = Conv2d(channels // 2, channels, 1)

    def forward(self, x):
        return self.cw(x[..., 0::2]), self.cw(x[..., 1::2])


class EUCB2(nn.Module):
    """Depthwise conv + BN + ReLU -> (identity) channel shuffle -> 1x1."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.up_dwc = nn.Sequential(
            Conv2d(in_channels, in_channels, 3, padding=1, groups=in_channels,
                   bias=False),
            BatchNorm2d(in_channels), nn.ReLU())
        self.pwc = nn.Sequential(Conv2d(in_channels, out_channels, 1))

    def forward(self, x):
        return self.pwc(channel_shuffle(self.up_dwc(x), self.in_channels))


class DySample(nn.Module):
    """Dynamic 2x upsampler ('lp' style, 4 groups) + EUCB2. The base grid is
    i + sin(pi*(i+1)/S) (reference quirk); each group of consecutive
    channels is sampled bilinearly with its own grid, border-clamped.
    ``grouped`` (the counterpart of ``CEIGM_GS_GROUP``): True samples all
    groups in one :func:`dysample_grid_sample`; False regroups the channels
    and samples them with the single-grid op
    (:func:`dysample_grid_sample_pergroup`). Both compute the same
    function."""

    SCALE, GROUPS = 2, 4

    def __init__(self, in_channels: int, out_channels: int,
                 grouped: bool = True):
        super().__init__()
        self.grouped = grouped
        oc = 2 * self.GROUPS * self.SCALE ** 2
        self.offset = nn.Sequential(
            Conv2d(in_channels, oc, 1),
            Conv2d(oc, oc, 3, padding=2, dilation=2, bias=False))
        self.eu = EUCB2(in_channels, out_channels)
        self.register_buffer("init_pos", torch.from_numpy(
            self._init_pos().reshape(-1)), persistent=False)

    def _init_pos(self) -> np.ndarray:
        """(2, groups, s, s): [0] = x offset per subpixel column i, [1] = y
        offset per subpixel row j (reference _init_pos order)."""
        s = self.SCALE
        base = (np.arange((-s + 1) / 2, (s - 1) / 2 + 1) / s).astype(
            np.float32)
        pos = np.zeros((2, self.GROUPS, s, s), np.float32)
        pos[0] = base[None, None, :]
        pos[1] = base[None, :, None]
        return pos

    def forward(self, x):
        s, g = self.SCALE, self.GROUPS
        B, H, W, C = x.shape
        off = self.offset(x) / g + self.init_pos.to(x.dtype)
        off = off.reshape(B, H, W, 2, g, s, s)
        ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)
        ring = sp_context.ring()
        Hg = H if ring is None else H * ring.n          # the image's H
        bw = ar(W) + torch.sin(math.pi * (ar(W) + 1) / W)
        bh = ar(Hg) + torch.sin(math.pi * (ar(Hg) + 1) / Hg)
        # each image's rows of the base grid: the shard's rows of the image's
        rows = bh[None] if ring is None else sp_ops.shard_rows(bh, ring, B)
        cx = 2.0 * (bw[None, None, :, None, None, None] + off[..., 0, :, :, :]) \
            / W - 1.0
        cy = 2.0 * (rows[:, :, None, None, None, None] + off[..., 1, :, :, :]) \
            / Hg - 1.0
        # pixel-shuffle the (j, i) subpixels: (B, H, W, g, s, s) ->
        # (B, H*s, W*s, g)
        shuffle = lambda c: c.permute(0, 1, 4, 2, 5, 3).reshape(
            B, H * s, W * s, g)
        grid = torch.stack([shuffle(cx), shuffle(cy)], dim=-1)
        sample = (dysample_grid_sample if self.grouped
                  else dysample_grid_sample_pergroup)
        if ring is not None:
            # the offsets are unbounded: a sample may read any row, so the
            # source is gathered whole over H
            return self.eu(sp_ops.sample_rows(sample, x, grid, ring))
        return self.eu(sample(x, grid))


class _CmLayer(nn.Module):
    def __init__(self, dim: int, drop_paths: Sequence[float], **routes):
        super().__init__()
        self.blocks = nn.ModuleList(
            BlockMamba(dim, 4.0, float(p), use_custom_ffn=True, norm_eps=1e-5,
                       **routes) for p in drop_paths)


class Front(nn.Module):
    """BlockMamba per drop-path rate, with the CustomFfn (reference Front
    / cm)."""

    def __init__(self, dim: int, drop_paths: Sequence[float], **routes):
        super().__init__()
        self.cm_layer = _CmLayer(dim, drop_paths, **routes)

    def forward(self, x, generator=None):
        for blk in self.cm_layer.blocks:
            x = blk(x, generator)
        return x


class EMCAD(nn.Module):
    """The decoder. ``channels``: the reversed encoder pyramid, e.g.
    (448, 348, 128, 64). Input: 4 NHWC features, coarse to fine; output:
    logits upsampled 4x from the finest scale. ``quant_scan`` and ``dwconv``
    select the Front blocks' :class:`QuadGroupSS2D` routes,
    ``dysample_grouped`` the upsamplers' (:class:`DySample`)."""

    FRONT_DEPTHS = (3, 2, 2)

    def __init__(self, channels: Sequence[int] = (448, 348, 128, 64),
                 num_classes: int = 9, drop_path_rate: float = 0.2,
                 quant_scan: bool = False, dwconv: str = "library",
                 dysample_grouped: bool = True):
        super().__init__()
        ch = list(channels)
        # stochastic depth rate -> 0 over the 7 Front blocks (train only)
        dpr = np.linspace(drop_path_rate, 0.0, sum(self.FRONT_DEPTHS))
        starts = np.cumsum([0, *self.FRONT_DEPTHS])
        for idx, c in zip((4, 3, 2, 1), ch):
            self.add_module(f"cc{idx}", SplitChannelsOddEven(c))
            self.add_module(f"para{idx}", ParallelAttentionFusion(c))
        for i, idx in enumerate((3, 2, 1)):
            self.add_module(f"eucb{idx}", DySample(ch[i], ch[i + 1],
                                                   dysample_grouped))
            self.add_module(f"lgag{idx}", LGAG(ch[i + 1] // 2))
            self.add_module(f"f{i + 1}", Front(
                ch[i + 1], dpr[starts[i]:starts[i + 1]],
                quant_scan=quant_scan, dwconv=dwconv))
        self.out_head1 = Conv2d(ch[3], num_classes, 1)

    def _mscam(self, d, idx):
        c1, s1 = getattr(self, f"cc{idx}")(d)
        return getattr(self, f"para{idx}")(c1, s1)

    def forward(self, feats, generator=None):
        d = self._mscam(feats[0], 4)
        for i, idx in enumerate((3, 2, 1)):
            d = getattr(self, f"eucb{idx}")(d)
            x = getattr(self, f"lgag{idx}")(d, feats[i + 1])
            d = self._mscam(getattr(self, f"f{i + 1}")(d + x, generator),
                            idx)
        return bilinear_upsample(self.out_head1(d), 4)
