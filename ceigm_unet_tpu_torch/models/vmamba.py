"""VMamba backbone and the legacy MSVM-UNet decoder, channel-last (NHWC).

Counterpart of ``ceigm_unet_tpu/models/vmamba.py``: :class:`VSSBlock`,
:class:`MsMlp` (MS_MLP) and :class:`Mlp`, :class:`MSVSS`, :class:`LKPE` /
:class:`FLKPE`, :class:`UpBlock`, :class:`LegacyDecoder`,
:class:`PatchMerging2D`, :class:`VSSM` and :class:`MSVMUNetLegacy`. Module
names follow the reference torch modules, so the ``state_dict`` keys are
the ones ``ceigm_unet_tpu/convert/vssm_import.py`` reads: ``encoder.*``
(``patch_embed.{0,2,5,7}``, ``layers.{i}.blocks.{j}.*``,
``downsamples.{i}.{1,3}``) and ``decoder.*`` (``layers.{i}.{up.expand.
{0,1,3}, up.norm, concat_layer, vss_layer.blocks.{j}.*}``,
``out_layers.0.*``). Parameters stay fp32; the input's dtype is the compute
dtype. In the live configs every SS2D runs at d_state 1, so through
``sscan_dir`` (K10).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ceigm_unet_tpu_torch.models.groupmamba import check_stages
from ceigm_unet_tpu_torch.models.layers import (BatchNorm2d, Conv2d,
                                                DropPath, LayerNorm, Linear,
                                                dw_conv)
from ceigm_unet_tpu_torch.models.ss2d import SS2D, init_ssm_params
from ceigm_unet_tpu_torch.ops.activations import gelu
from ceigm_unet_tpu_torch.parallel import sp_context, sp_ops
from ceigm_unet_tpu_torch.utils.debug import DebugGuards, attach


class Gelu(nn.Module):
    """The erf-polynomial GELU of ``ops/activations.py`` as a module."""

    def forward(self, x):
        return gelu(x)


class InceptionDWConv2dBands(nn.Module):
    """InceptionDWConv2d2: channels split ``[identity C-3g | hw | w | h]``,
    g = C/8; the square 3-5-7 chain, the 1xk -> 1x5 band and the kx1 -> 5x1
    band on the three g slices; the input added back."""

    def __init__(self, dim: int, band_kernel_size: int = 11,
                 branch_ratio: float = 0.125):
        super().__init__()
        g = int(dim * branch_ratio)
        k = band_kernel_size
        self.split = (dim - 3 * g, g, g, g)
        self.dwconv_hw = nn.Sequential(dw_conv(g, 3), dw_conv(g, 5),
                                       dw_conv(g, 7))
        self.dwconv_w = nn.Sequential(dw_conv(g, (1, k)), dw_conv(g, (1, 5)))
        self.dwconv_h = nn.Sequential(dw_conv(g, (k, 1)), dw_conv(g, (5, 1)))

    def forward(self, x):
        xi, xhw, xw, xh = torch.split(x, self.split, dim=-1)
        return x + torch.cat([xi, self.dwconv_hw(xhw), self.dwconv_w(xw),
                              self.dwconv_h(xh)], dim=-1)


class MsMlp(nn.Module):
    """MS_MLP: fc1 -> GELU -> InceptionDWConv2dBands -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.multiscale_conv = InceptionDWConv2dBands(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.multiscale_conv(gelu(self.fc1(x))))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))); x + DropPath(MLP(LN2(x))). With
    ``post_norm`` the first branch is LN(SS2D(x)). (The JAX module's
    ``ssm_ratio`` / ``mlp_ratio`` 0, which drop a branch, have no caller and
    are not ported.)"""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 ssm_d_state: int = 1, ssm_ratio: float = 1.0,
                 ssm_conv: int = 3, ssm_conv_bias: bool = False,
                 forward_type: str = "v05_noz", mlp_ratio: float = 4.0,
                 mlp_type: str = "ms", post_norm: bool = False):
        super().__init__()
        self.post_norm = post_norm
        self.norm = LayerNorm(dim)
        self.op = SS2D(dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                       d_conv=ssm_conv, conv_bias=ssm_conv_bias,
                       forward_type=forward_type)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        mlp = MsMlp if mlp_type == "ms" else Mlp
        self.mlp = mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = (self.norm(self.op(x)) if self.post_norm
             else self.op(self.norm(x)))
        x = x + self.drop_path(y, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class VSSLayer(nn.Module):
    """A stack of blocks (key ``blocks.{j}``)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x


class MSVSS(VSSLayer):
    """VSSBlocks in the live decoder config (d_state 1, ssm_ratio 1, conv
    bias off, ``v05_noz``, MS_MLP); block d takes ``drop_paths[d]``, or the
    last entry past its end."""

    def __init__(self, dim: int, depth: int,
                 drop_paths: Sequence[float] = (0.0,)):
        super().__init__([
            VSSBlock(dim, drop_path=float(
                drop_paths[min(d, len(drop_paths) - 1)]))
            for d in range(depth)])


def _pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, p*p*c) -> (B, H*p, W*p, c), channels in ``(p1 p2 c)``
    order."""
    B, H, W, C = x.shape
    c = C // (p * p)
    return x.reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(
        B, H * p, W * p, c)


class LKPE(nn.Module):
    """Large-kernel patch expand 2x: conv1x1 (C -> 2C) -> BN -> ReLU ->
    dw3x3, pixel shuffle to C/2 at 2x, LN."""

    def __init__(self, dim: int):
        super().__init__()
        c2 = 2 * dim
        self.expand = nn.Sequential(Conv2d(dim, c2, 1), BatchNorm2d(c2),
                                    nn.ReLU(), dw_conv(c2, 3))
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        return self.norm(_pixel_shuffle(self.expand(x), 2))


class FLKPE(nn.Module):
    """Final 4x expand and classifier head: conv1x1 (C -> 16C) -> BN ->
    ReLU -> dw3x3, pixel shuffle to C at 4x, LN, conv1x1 to the classes."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        c16 = 16 * dim
        self.expand = nn.Sequential(Conv2d(dim, c16, 1), BatchNorm2d(c16),
                                    nn.ReLU(), dw_conv(c16, 3))
        self.norm = LayerNorm(dim)
        self.out = Conv2d(dim, num_classes, 1)

    def forward(self, x):
        return self.out(self.norm(_pixel_shuffle(self.expand(x), 4)))


class UpBlock(nn.Module):
    """LKPE -> concat the skip -> 1x1 projection -> MSVSS."""

    def __init__(self, in_dim: int, skip_dim: int, out_channels: int,
                 depth: int, drop_paths: Sequence[float]):
        super().__init__()
        self.up = LKPE(in_dim)
        self.concat_layer = Linear(in_dim // 2 + skip_dim, out_channels)
        self.vss_layer = MSVSS(out_channels, depth, drop_paths)

    def forward(self, x, skip, generator=None):
        x = torch.cat([self.up(x), skip], dim=-1)
        return self.vss_layer(self.concat_layer(x), generator)


class LegacyDecoder(nn.Module):
    """The published MSVM-UNet decoder. ``dims`` is the reversed encoder
    pyramid, e.g. (768, 384, 192, 96); UpBlock i takes ``depths[i + 1]``
    blocks and the drop paths ``linspace(rate, 0, 2 * (len(dims) - 1))``
    sliced as the JAX package slices them."""

    def __init__(self, dims: Sequence[int], num_classes: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 drop_path_rate: float = 0.2):
        super().__init__()
        dims = list(dims)
        dpr = np.linspace(drop_path_rate, 0.0, (len(dims) - 1) * 2)
        self.layers = nn.ModuleList()
        for i in range(1, len(dims)):
            lo, hi = sum(depths[:i - 1]), sum(depths[:i])
            self.layers.append(UpBlock(dims[i - 1], dims[i], dims[i],
                                       depths[i], list(dpr[lo:hi]) or [0.0]))
        self.out_layers = nn.ModuleList([FLKPE(dims[-1], num_classes)])

    def forward(self, feats, generator=None):
        x = feats[0]
        for i, layer in enumerate(self.layers):
            x = layer(x, feats[i + 1], generator)
        return self.out_layers[0](x)


class PatchMerging2D(nn.Module):
    """Downsample v1: space-to-depth [x00, x10, x01, x11] (odd sizes padded)
    -> LN(4C) -> Linear(4C -> out_dim, or 2C; no bias). On H-shards
    (``parallel/sp_context.py``) each shard merges its own row pairs, and
    odd shard rows raise."""

    def __init__(self, dim: int, out_dim: int = -1):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, out_dim if out_dim > 0 else 2 * dim,
                                bias=False)

    def forward(self, x):
        H, W = x.shape[1:3]
        if H % 2 and sp_context.ring() is not None:
            raise ValueError(f"sharded PatchMerging2D: the shard's H/n = {H} "
                             f"is odd")
        if H % 2 or W % 2:
            x = nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


VSSM_CONFIGS = {
    # test-only miniature; not a reference config
    "vssm_test": dict(dims=(16, 32, 48, 64), depths=(1, 1, 1, 1),
                      drop_path_rate=0.0),
    "tiny_0230s": dict(dims=(96, 192, 384, 768), depths=(2, 2, 8, 2),
                       drop_path_rate=0.2),
    "small_0229s": dict(dims=(96, 192, 384, 768), depths=(2, 2, 20, 2),
                        drop_path_rate=0.3),
}


def _downsample(dim: int, out_dim: int, version: str) -> nn.Module:
    if version == "v1":
        return PatchMerging2D(dim, out_dim)
    k, pad = (2, 0) if version == "v2" else (3, 1)
    return nn.Sequential(nn.Identity(), Conv2d(dim, out_dim, k, 2, pad),
                         nn.Identity(), LayerNorm(out_dim))


class VSSM(nn.Module):
    """VMamba backbone (live config: SS2D d_state 1, ssm_ratio 1, conv bias
    off, ``v05_noz``, patch embed v2, downsample v3, plain MLP ratio 4).
    Returns the four stages' features, channel-last. ``img_size`` sizes the
    optional ``pos_embed`` (1, C, img/4, img/4). On H-shards
    (``parallel/sp_context.py``) n must divide every stage's map
    (``groupmamba.check_stages``), and each shard adds its own rows of
    ``pos_embed``."""

    def __init__(self, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 8, 2),
                 drop_path_rate: float = 0.2,
                 patchembed_version: str = "v2",
                 downsample_version: str = "v3", posembed: bool = False,
                 img_size: int = 224, forward_type: str = "v05_noz",
                 ssm_d_state: int = 1, ssm_ratio: float = 1.0,
                 ssm_conv_bias: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        d0 = dims[0]
        if patchembed_version == "v2":
            self.patch_embed = nn.Sequential(
                Conv2d(3, d0 // 2, 3, 2, 1), nn.Identity(),
                LayerNorm(d0 // 2), nn.Identity(), Gelu(),
                Conv2d(d0 // 2, d0, 3, 2, 1), nn.Identity(), LayerNorm(d0))
        else:
            self.patch_embed = nn.Sequential(Conv2d(3, d0, 4, 4),
                                             nn.Identity(), LayerNorm(d0))
        self.pos_embed = (nn.Parameter(torch.zeros(
            1, d0, img_size // 4, img_size // 4)) if posembed else None)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        cur = 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            self.layers.append(VSSLayer([
                VSSBlock(dim, drop_path=float(dpr[cur + d]),
                         ssm_d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                         ssm_conv_bias=ssm_conv_bias,
                         forward_type=forward_type, mlp_ratio=mlp_ratio,
                         mlp_type="plain") for d in range(depth)]))
            cur += depth
            if i < len(dims) - 1:
                self.downsamples.append(_downsample(dim, dims[i + 1],
                                                    downsample_version))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        ring = sp_context.ring()
        if ring is not None:
            check_stages(x.shape[1] * ring.n, x.shape[2], ring.n,
                         len(self.layers))
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            pos = self.pos_embed[0].permute(1, 2, 0).to(x.dtype)
            x = x + (pos if ring is None
                     else sp_ops.shard_rows(pos, ring, x.shape[0]))
        feats = []
        for i, layer in enumerate(self.layers):
            x = layer(x, generator)
            feats.append(x)
            if i < len(self.downsamples):
                x = self.downsamples[i](x)
        return feats


class MSVMUNetLegacy(nn.Module):
    """The upstream MSVM-UNet: VSSM encoder + the legacy decoder. Takes
    (B, H, W, 1|3) NHWC input (1 channel repeats to 3), computes in
    ``dtype`` and returns (B, H, W, classes) logits in ``dtype``."""

    def __init__(self, num_classes: int = 9, enc_name: str = "tiny_0230s",
                 dtype: torch.dtype = torch.float32,
                 decoder_drop_path_rate: float = 0.2):
        super().__init__()
        cfg = VSSM_CONFIGS[enc_name]
        self.dtype = dtype
        self.encoder = VSSM(**cfg)
        self.decoder = LegacyDecoder(dims=list(cfg["dims"])[::-1],
                                     num_classes=num_classes,
                                     drop_path_rate=decoder_drop_path_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the stochastic-depth masks in training."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        feats = self.encoder(x.to(self.dtype).contiguous(), generator)
        return self.decoder(feats[::-1], generator)


def init_legacy_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init after the JAX package's schemes: Linear and the
    encoder's dense convs trunc-normal(0.02); every other conv normal(0,
    sqrt(2/fan_out)), fan_out = kh*kw*out/groups; SSM parameters as
    :func:`init_ssm_params`; ``pos_embed`` trunc-normal(0.02); biases 0,
    norms at weight 1, bias 0."""
    g = generator
    trunc = lambda w: nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04,
                                            generator=g)
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            trunc(m.weight)
        elif isinstance(m, Conv2d):
            if m.groups == 1 and name.startswith("encoder."):
                trunc(m.weight)
            else:
                kh, kw = m.kernel_size
                fan_out = kh * kw * m.out_channels // m.groups
                nn.init.normal_(m.weight, std=math.sqrt(2.0 / fan_out),
                                generator=g)
        elif isinstance(m, SS2D):
            init_ssm_params(m, g)
        elif isinstance(m, VSSM) and m.pos_embed is not None:
            trunc(m.pos_embed)
        if isinstance(m, (Linear, Conv2d)) and m.bias is not None:
            nn.init.zeros_(m.bias)


def build_legacy_model(num_classes: int = 9, enc_name: str = "tiny_0230s",
                       dtype: torch.dtype = torch.float32,
                       device: Union[str, torch.device] = "cuda",
                       seed: int = 0,
                       decoder_drop_path_rate: float = 0.2,
                       debug: Optional[DebugGuards] = None
                       ) -> MSVMUNetLegacy:
    """The legacy MSVM-UNet with random weights from a CPU
    ``torch.Generator`` seeded with ``seed``, in eval mode, on ``device``
    (the card unless the caller asks for ``"cpu"``). Parameters stay fp32;
    ``dtype`` is the compute dtype. ``decoder_drop_path_rate`` is the
    decoder's stochastic depth (the encoder's is its config's). ``debug``:
    the SS2D modules' nan/inf checks and captures (``utils/debug.py``);
    None, the default, runs none."""
    model = MSVMUNetLegacy(num_classes=num_classes, enc_name=enc_name,
                           dtype=dtype,
                           decoder_drop_path_rate=decoder_drop_path_rate)
    init_legacy_weights(model, torch.Generator().manual_seed(seed))
    return attach(model, debug).to(device).eval()
