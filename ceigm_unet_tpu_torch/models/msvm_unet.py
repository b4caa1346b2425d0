"""MSVM-UNet: GroupMamba encoder + EMCAD decoder.

Counterpart of ``ceigm_unet_tpu/models/msvm_unet.py``. The model takes
(B, H, W, 1|3) NHWC input, repeats a 1-channel input to 3 channels,
computes in ``dtype`` and returns (B, H, W, classes) NHWC logits in
``dtype``. ``state_dict`` keys are the reference
torch model's (``encoder.gm_encoder.*``, ``decoder.*``). ``model.train()``
selects training mode (batch-statistics BatchNorm, stochastic depth drawn
from the generator passed to ``forward``).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ceigm_unet_tpu_torch.models.emcad import EMCAD
from ceigm_unet_tpu_torch.models.groupmamba import (GROUPMAMBA_CONFIGS,
                                                    GroupMamba)
from ceigm_unet_tpu_torch.models.layers import Conv2d, Linear
from ceigm_unet_tpu_torch.models.ss2d import SS2DGroup, init_ssm_params


class _Encoder(nn.Module):
    def __init__(self, **cfg):
        super().__init__()
        self.gm_encoder = GroupMamba(**cfg)


class MSVMUNet(nn.Module):
    def __init__(self, num_classes: int = 9, enc_name: str = "gm_tiny",
                 dtype: torch.dtype = torch.float32,
                 decoder_drop_path_rate: float = 0.2,
                 quant_scan: bool = False, dwconv: str = "library",
                 dysample_grouped: bool = True):
        super().__init__()
        cfg = GROUPMAMBA_CONFIGS[enc_name]
        self.dtype = dtype
        routes = dict(quant_scan=quant_scan, dwconv=dwconv)
        self.encoder = _Encoder(**cfg, **routes)
        self.decoder = EMCAD(channels=tuple(cfg["embed_dims"])[::-1],
                             num_classes=num_classes,
                             drop_path_rate=decoder_drop_path_rate,
                             dysample_grouped=dysample_grouped, **routes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the stochastic-depth masks in training."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        feats = self.encoder.gm_encoder(x.to(self.dtype).contiguous(),
                                        generator)
        return self.decoder(feats[::-1], generator)


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
            init_ssm_params(m, g)


def build_model(num_classes: int = 9, enc_name: str = "gm_tiny",
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0,
                decoder_drop_path_rate: float = 0.2,
                quant_scan: bool = False, dwconv: str = "library",
                dysample_grouped: bool = True) -> MSVMUNet:
    """Flagship factory: random weights from a CPU ``torch.Generator``
    seeded with ``seed``, in eval mode, on ``device`` (the card unless the
    caller asks for ``"cpu"``). Parameters stay fp32; ``dtype`` is the
    compute dtype. ``decoder_drop_path_rate`` is the decoder's stochastic
    depth (the encoder's is 0, as in the reference).

    Three routes, each the counterpart of a JAX package switch that selects
    a TPU kernel, with that package's defaults (no route adds a parameter,
    so every route loads the same weights):

    - ``quant_scan`` (``CEIGM_QUANT=1``): int8 storage of the quad scan's u
      and dt, scanned by ``quad_scan_ln_cat_q8``; inference only, so the
      model's parameters are built not requiring grad, and its forward
      runs as it is, with grad mode on or off.
    - ``dwconv`` (``CEIGM_BLDW``): ``"library"`` runs the quad blocks'
      depthwise conv as ``F.conv2d``, ``"kernel"`` as ``dwconv3x3``.
    - ``dysample_grouped`` (``CEIGM_GS_GROUP``): True samples DySample's
      four groups in one ``dysample_grid_sample``; False takes the per-group
      route through the single-grid ``grid_sample_bilinear_fused``.
    """
    model = MSVMUNet(num_classes=num_classes, enc_name=enc_name, dtype=dtype,
                     decoder_drop_path_rate=decoder_drop_path_rate,
                     quant_scan=quant_scan, dwconv=dwconv,
                     dysample_grouped=dysample_grouped)
    init_weights(model, torch.Generator().manual_seed(seed))
    if quant_scan:
        model.requires_grad_(False)
    return model.to(device).eval()
