"""Upstream GroupMamba classification checkpoints -> the port's encoder.

Counterpart by name of ``ceigm_unet_tpu/convert/torch_import.py``. The
port's modules carry the reference's ``state_dict`` names, so of that
module's converters only the key remapping of a pretrained classification
checkpoint is needed here (reference gm-unet/model/gm/__init__.py:27-58).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

# the classifier's head and final norm, which the segmentation encoder lacks
HEAD_KEYS = ("norm.weight", "norm.bias", "head.weight", "head.bias",
             "dist_head.weight", "dist_head.bias")


def remap_pretrained_groupmamba_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Upstream GroupMamba names -> gm-unet GroupMamba names: the head and
    final-norm keys dropped, ``layers.N.downsample`` -> ``downsamples.N``,
    ``ln_1`` -> ``norm``, ``self_attention`` -> ``op``."""
    out = {}
    for k, v in sd.items():
        if k in HEAD_KEYS:
            continue
        k = re.sub(r"^layers\.(\d+)\.downsample", r"downsamples.\1", k)
        k = k.replace("ln_1", "norm").replace("self_attention", "op")
        out[k] = v
    return out
