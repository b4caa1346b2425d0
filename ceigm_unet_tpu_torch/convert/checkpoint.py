"""Reference (PyTorch Lightning) checkpoints: the port's model in and out.

The port's ``state_dict`` keys are the reference's, so a Lightning file
loads with no conversion once its ``_model.`` prefix is stripped (reference
inference.get_model, inference.py:175-221), and the training loop saves
its checkpoints in that format (:func:`save_checkpoint`), which
:func:`load_model` and the JAX package's ``load_variables`` read back. The
JAX package's own orbax directories need orbax and JAX;
``convert/jax_import.py`` bridges JAX variables, and :func:`load_model`
refuses such a directory.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Union

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


def save_checkpoint(ckpt_dir: str, name: str, model: torch.nn.Module,
                    step: int, epoch: int,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<ckpt_dir>/<name>.ckpt`` as Lightning lays one out: the
    model's ``state_dict`` (parameters and BatchNorm buffers, on the CPU)
    under ``_model.``, ``global_step`` (the optimizer's step count, which
    the LR schedule reads), ``epoch`` and the scalars of ``extra``. The file
    is written whole and then renamed into place. Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name + ".ckpt")
    payload = {"state_dict": {"_model." + k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
               "global_step": int(step), "epoch": int(epoch)}
    payload.update(extra or {})
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload :func:`save_checkpoint` wrote (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)
