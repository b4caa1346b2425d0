"""Entry point: the flagship model (MSVM-UNet gm_tiny, 9-class Synapse,
224x224, 1 channel) and an example input, as ``__graft_entry__.entry`` gives
them for the JAX package."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ceigm_unet_tpu_torch.models import MSVMUNet, build_model


def entry(device: Union[str, torch.device] = "cuda",
          dtype: torch.dtype = torch.float32,
          seed: int = 0) -> Tuple[MSVMUNet, torch.Tensor]:
    """(model, x): the seeded flagship model in eval mode on ``device`` and
    a zero (1, 224, 224, 1) NHWC input there; ``model(x)`` gives logits."""
    model = build_model(num_classes=9, enc_name="gm_tiny", dtype=dtype,
                        device=device, seed=seed)
    return model, torch.zeros((1, 224, 224, 1), device=device)
