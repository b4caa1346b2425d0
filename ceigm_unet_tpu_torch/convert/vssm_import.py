"""VSSM (VMamba backbone) checkpoints -> the legacy MSVM-UNet's encoder.

Counterpart of ``ceigm_unet_tpu/convert/vssm_import.py``, which converts a
VSSM classification checkpoint (reference model/vmamba/__init__.py:117-171,
``vssm1_tiny_0230s`` / ``vssm1_small_0229s``) into the JAX package's tree.
The port's ``VSSM`` carries the reference's ``state_dict`` names and
layouts (``models/vmamba.py``), so no key is renamed and no tensor is
transposed; ``pos_embed`` stays in its (1, C, H, W) storage, which the
port's forward reads as the JAX converter's transposed copy. What a load
owes is:

- the file's tensors, unwrapped from ``"model"`` (VMamba's releases) or
  ``"state_dict"``;
- the classifier's keys dropped (``classifier.*``: its final norm and head,
  which the segmentation encoder lacks);
- a strict load into ``model.encoder``: a key the encoder lacks, or one it
  has that the file lacks (``pos_embed`` included), raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import torch
from torch import nn

CLASSIFIER_PREFIX = "classifier."


def vssm_encoder_state_dict(ckpt: Union[str, Mapping[str, Any]]
                            ) -> Dict[str, Any]:
    """A VSSM checkpoint (a path, or the loaded object) -> the encoder's
    tensors: unwrapped from ``"model"`` / ``"state_dict"``, the
    classifier's keys dropped."""
    if isinstance(ckpt, str):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=False)
    for wrapper in ("model", "state_dict"):
        if wrapper in ckpt and isinstance(ckpt[wrapper], Mapping):
            ckpt = ckpt[wrapper]
            break
    return {k: v for k, v in ckpt.items()
            if not k.startswith(CLASSIFIER_PREFIX)}


def load_vssm_encoder(model: nn.Module,
                      ckpt: Union[str, Mapping[str, Any]]) -> nn.Module:
    """Load a VSSM classification checkpoint into ``model.encoder`` (an
    ``MSVMUNetLegacy``, or anything with a ``VSSM`` ``encoder``), strictly;
    the decoder is not touched. Returns the model."""
    model.encoder.load_state_dict(vssm_encoder_state_dict(ckpt), strict=True)
    return model


def load_msvm_legacy_state_dict(model: nn.Module,
                                enc_state_dict: Mapping[str, Any],
                                dec_state_dict: Mapping[str, Any]
                                ) -> nn.Module:
    """(VSSM encoder state_dict, legacy decoder state_dict) -> ``model``
    (an ``MSVMUNetLegacy``), each part loaded strictly: the counterpart of
    ``convert_msvm_legacy_state_dict``. The encoder's part goes through
    :func:`vssm_encoder_state_dict` (a wrapped checkpoint or one with the
    classifier's keys loads). Returns the model."""
    load_vssm_encoder(model, enc_state_dict)
    model.decoder.load_state_dict(dict(dec_state_dict), strict=True)
    return model
