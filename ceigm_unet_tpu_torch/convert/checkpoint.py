"""Reference (PyTorch Lightning) checkpoints -> the port's model.

The port's ``state_dict`` keys are the reference's, so a Lightning file
loads with no conversion once its ``_model.`` prefix is stripped (reference
inference.get_model, inference.py:175-221). The JAX package's own orbax
directories need orbax and JAX; ``convert/jax_import.py`` bridges JAX
variables, and :func:`load_model` refuses such a directory.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import torch

from ceigm_unet_tpu_torch.models import MSVMUNet, build_model


def strip_lightning_prefix(sd: Mapping[str, Any],
                           prefix: str = "_model.") -> Dict[str, Any]:
    """Keys without ``prefix``; keys without it stay as they are."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def load_model(ckpt_path: str, num_classes: int, enc_name: str = "gm_tiny",
               device: Union[str, torch.device] = "cuda",
               dtype: torch.dtype = torch.float32) -> MSVMUNet:
    """The MSVM-UNet of a ``.ckpt`` / ``.pth`` file, in eval mode on
    ``device`` (the card unless the caller asks for ``"cpu"``) computing in
    ``dtype``. Only the file's ``state_dict`` (or the file itself, when it
    holds a bare one) is read; optimizer state and hyperparameters are not.
    Every key must match: a mismatch raises, naming the missing and the
    unexpected keys."""
    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory (an orbax checkpoint of the JAX "
            "package?): the port reads .ckpt/.pth files; bridge JAX "
            "variables with ceigm_unet_tpu_torch.convert.jax_import")
    # Lightning files pickle more than tensors, as the reference reads them
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = strip_lightning_prefix(raw.get("state_dict", raw))
    model = build_model(num_classes=num_classes, enc_name=enc_name,
                        dtype=dtype, device=device)
    want = set(model.state_dict())
    missing, unexpected = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or unexpected:
        raise KeyError(f"{ckpt_path} does not match MSVM-UNet {enc_name} "
                       f"with {num_classes} classes: missing keys "
                       f"{missing}, unexpected keys {unexpected}")
    model.load_state_dict(sd, strict=True)
    return model
