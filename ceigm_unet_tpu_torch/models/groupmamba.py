"""GroupMamba hierarchical encoder (NHWC).

Counterpart of ``ceigm_unet_tpu/models/groupmamba.py``: Stem (stride 4) ->
4 stages of [patch embed, BlockMamba x depth, LayerNorm], returning the
4-level feature pyramid. Module names follow the reference torch encoder,
so its ``state_dict`` keys are the ones ``convert/torch_import.py`` reads.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ceigm_unet_tpu_torch.models.layers import (BatchNorm2d, Conv2d,
                                                CustomFfn, DropPath,
                                                LayerNorm, Linear, Pvt2Ffn)
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D


class GroupMambaLayer(QuadGroupSS2D):
    """Modulated group mamba: LN -> channel-affinity SE -> QuadGroupSS2D *
    skip_scale * x -> channel modulation -> the SAME LN again (a reference
    quirk kept for weight parity) -> Linear proj. The four scan groups are
    this module's own ``mamba_g1..g4``, as in the reference."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, dim // 16)
        self.fc2 = Linear(dim // 16, dim)
        self.skip_scale = nn.Parameter(torch.ones(1))
        self.proj = Linear(dim, dim)

    def forward(self, x):
        xn = self.norm(x)
        zc = self.fc2(torch.relu(self.fc1(xn.mean(dim=(1, 2)))))
        affinity = torch.sigmoid(zc)[:, None, None, :]
        y = self.scan_groups(xn) * self.skip_scale.to(x.dtype) * xn
        return self.proj(self.norm(y * affinity))


class BlockMamba(nn.Module):
    """x + DropPath(GroupMambaLayer(x)); x + DropPath(FFN(LN(x)))."""

    def __init__(self, dim: int, mlp_ratio: float, drop_path: float = 0.0,
                 use_custom_ffn: bool = False, norm_eps: float = 1e-5):
        super().__init__()
        self.attn = GroupMambaLayer(dim)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        hidden = int(dim * mlp_ratio)
        self.mlp = (CustomFfn if use_custom_ffn else Pvt2Ffn)(dim, hidden)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path1(self.attn(x))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class Stem(nn.Module):
    """conv7x7 s2 (BN, ReLU) -> 2x conv3x3 (BN, ReLU) -> conv3x3 s2 -> LN,
    with torch's symmetric padding on the strided convs."""

    def __init__(self, in_ch: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, hidden_dim, 7, 2, 3, bias=False),
            BatchNorm2d(hidden_dim), nn.ReLU(),
            Conv2d(hidden_dim, hidden_dim, 3, 1, 1, bias=False),
            BatchNorm2d(hidden_dim), nn.ReLU(),
            Conv2d(hidden_dim, hidden_dim, 3, 1, 1, bias=False),
            BatchNorm2d(hidden_dim), nn.ReLU())
        self.proj = Conv2d(hidden_dim, out_dim, 3, 2, 1)
        self.norm = LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(self.conv(x)))


class DownSample(nn.Module):
    """conv3x3 s2 + LN."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj = Conv2d(in_dim, out_dim, 3, 2, 1)
        self.norm = LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


GROUPMAMBA_CONFIGS = {
    # test-only miniature; not a reference config
    "gm_test": dict(stem_hidden_dim=8, embed_dims=(16, 32, 48, 64),
                    mlp_ratios=(2, 2, 2, 2), depths=(1, 1, 1, 1)),
    "gm_tiny": dict(stem_hidden_dim=32, embed_dims=(64, 128, 348, 448),
                    mlp_ratios=(8, 8, 4, 4), depths=(3, 4, 9, 3)),
    "gm_small": dict(stem_hidden_dim=64, embed_dims=(64, 128, 348, 512),
                     mlp_ratios=(8, 8, 4, 4), depths=(3, 4, 16, 3)),
    "gm_base": dict(stem_hidden_dim=64, embed_dims=(96, 192, 424, 512),
                    mlp_ratios=(8, 8, 4, 4), depths=(3, 6, 21, 3)),
}


class GroupMamba(nn.Module):
    """4-stage backbone -> [C1@H/4, C2@H/8, C3@H/16, C4@H/32], NHWC."""

    def __init__(self, stem_hidden_dim: int = 32,
                 embed_dims: Sequence[int] = (64, 128, 348, 448),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4),
                 depths: Sequence[int] = (3, 4, 9, 3)):
        super().__init__()
        self.depths = tuple(depths)
        for i, (dim, ratio, depth) in enumerate(
                zip(embed_dims, mlp_ratios, depths)):
            self.add_module(
                f"patch_embed{i + 1}",
                Stem(3, stem_hidden_dim, dim) if i == 0
                else DownSample(embed_dims[i - 1], dim))
            self.add_module(f"block{i + 1}", nn.ModuleList(
                BlockMamba(dim, ratio, norm_eps=1e-6) for _ in range(depth)))
            self.add_module(f"norm{i + 1}", LayerNorm(dim, eps=1e-6))

    def forward(self, x):
        feats = []
        for i in range(len(self.depths)):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x)
            x = getattr(self, f"norm{i + 1}")(x)
            feats.append(x)
        return feats
