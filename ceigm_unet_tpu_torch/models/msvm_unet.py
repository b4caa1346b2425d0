"""MSVM-UNet: GroupMamba encoder + EMCAD decoder, inference.

Counterpart of ``ceigm_unet_tpu/models/msvm_unet.py``. The model takes
(B, H, W, 1|3) NHWC input, repeats a 1-channel input to 3 channels,
computes in ``dtype`` and returns (B, H, W, classes) NHWC logits in
``dtype``. ``state_dict`` keys are the reference
torch model's (``encoder.gm_encoder.*``, ``decoder.*``).
"""
from __future__ import annotations

import math
from typing import Union

import torch
from torch import nn

from ceigm_unet_tpu_torch.models.emcad import EMCAD
from ceigm_unet_tpu_torch.models.groupmamba import (GROUPMAMBA_CONFIGS,
                                                    GroupMamba)
from ceigm_unet_tpu_torch.models.layers import Conv2d, Linear
from ceigm_unet_tpu_torch.models.ss2d import SS2DGroup


class _Encoder(nn.Module):
    def __init__(self, **cfg):
        super().__init__()
        self.gm_encoder = GroupMamba(**cfg)


class MSVMUNet(nn.Module):
    def __init__(self, num_classes: int = 9, enc_name: str = "gm_tiny",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = GROUPMAMBA_CONFIGS[enc_name]
        self.dtype = dtype
        self.encoder = _Encoder(**cfg)
        self.decoder = EMCAD(channels=tuple(cfg["embed_dims"])[::-1],
                             num_classes=num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        feats = self.encoder.gm_encoder(x.to(self.dtype).contiguous())
        return self.decoder(feats[::-1])


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init after the JAX package's schemes: Linear
    trunc-normal(0.02); encoder convs normal(0, sqrt(2/fan_out)); decoder
    convs normal(0.02) (DySample offsets 1e-3); SSM projections and dt bias
    as ``utils/initializers.py``; norms at weight 1, bias 0."""
    g = generator
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Conv2d):
            if ".offset." in name:
                nn.init.normal_(m.weight, std=1e-3, generator=g)
            elif name.startswith("decoder.") and ".cm_layer." not in name:
                nn.init.normal_(m.weight, std=0.02, generator=g)
            else:
                kh, kw = m.kernel_size
                fan_out = kh * kw * m.out_channels // m.groups
                nn.init.normal_(m.weight, std=math.sqrt(2.0 / fan_out),
                                generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, SS2DGroup):
            D, R = m.d_inner, m.dt_rank
            nn.init.uniform_(m.x_proj_weight, -D ** -0.5, D ** -0.5,
                             generator=g)
            nn.init.uniform_(m.dt_projs_weight, -R ** -0.5, R ** -0.5,
                             generator=g)
            # softplus-inverse of a log-uniform dt in [1e-3, 0.1]
            r = torch.rand(m.dt_projs_bias.shape, generator=g)
            dt = torch.exp(r * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)).clamp_min(1e-4)
            with torch.no_grad():
                m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                n = m.A_logs.shape[-1]
                m.A_logs.copy_(torch.log(torch.arange(
                    1, n + 1, dtype=torch.float32)).expand_as(m.A_logs))
                m.Ds.fill_(1.0)


def build_model(num_classes: int = 9, enc_name: str = "gm_tiny",
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cpu",
                seed: int = 0) -> MSVMUNet:
    """Flagship factory: random weights from a CPU ``torch.Generator``
    seeded with ``seed``, in eval mode, on ``device``. Parameters stay fp32;
    ``dtype`` is the compute dtype."""
    model = MSVMUNet(num_classes=num_classes, enc_name=enc_name, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
