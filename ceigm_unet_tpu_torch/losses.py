"""Segmentation losses (reference gm-unet/loss.py).

Counterpart of ``ceigm_unet_tpu/losses.py``, with its semantics:
- soft Dice with smooth 1e-5, summed over the whole batch per class, then
  averaged over ALL classes including background;
- cross entropy from an fp32 log-softmax, the label picked by a one-hot
  mask-reduce, mean over pixels (or class-weighted);
- DiceCE = CE * ce_weight + Dice * dc_weight (live: 0.4 / 0.6);
- DiceFocal = softmax focal loss (monai semantics) + Dice.

Logits are (B, H, W, C) NHWC in the compute dtype and are upcast here;
labels are (B, H, W) integers.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int -> (B, H, W, C) float32."""
    return F.one_hot(labels.long(), num_classes).float()


def multiclass_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         apply_softmax: bool = True) -> torch.Tensor:
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1) if apply_softmax else logits
    probs = probs.float()
    target = one_hot(labels, num_classes)
    smooth = 1e-5
    # global (batch-wide) per-class sums, the reference convention
    intersect = (probs * target).sum((0, 1, 2))
    z = (probs * probs).sum((0, 1, 2))
    y = (target * target).sum((0, 1, 2))
    dice = 1.0 - (2.0 * intersect + smooth) / (z + y + smooth)
    if weight is not None:
        dice = dice * weight
    return dice.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    oh = one_hot(labels, logits.shape[-1])
    ll = (logp * oh).sum(-1)
    if class_weights is None:
        return -ll.mean()
    w = (oh * class_weights.float()).sum(-1)
    return -(ll * w).sum() / w.sum()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[float] = None) -> torch.Tensor:
    """Softmax focal loss, monai FocalLoss semantics (include_background,
    to_onehot_y, use_softmax, mean reduction)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(logp)
    target = one_hot(labels, logits.shape[-1])
    fl = -target * ((1.0 - p) ** gamma) * logp
    if alpha is not None:
        fl = fl * alpha
    return fl.mean()


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 ce_weight: float = 1.0, dc_weight: float = 1.0,
                 ce_class_weights: Optional[torch.Tensor] = None,
                 dc_class_weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    return (cross_entropy_loss(logits, labels, ce_class_weights) * ce_weight
            + multiclass_dice_loss(logits, labels, dc_class_weights)
            * dc_weight)


def dice_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                    fl_weight: float = 1.0, dc_weight: float = 1.0,
                    gamma: float = 2.0, alpha: Optional[float] = None
                    ) -> torch.Tensor:
    return (focal_loss(logits, labels, gamma, alpha) * fl_weight
            + multiclass_dice_loss(logits, labels) * dc_weight)


def make_loss(name: str = "DiceCELoss", **kwargs):
    """Registry-style factory (reference LOSSES)."""
    if name == "DiceCELoss":
        ce_w = kwargs.pop("ce_weight", 1.0)
        dc_w = kwargs.pop("dc_weight", 1.0)
        return lambda logits, labels: dice_ce_loss(
            logits, labels, ce_w, dc_w, **kwargs)
    if name == "DiceFocalLoss":
        fl_w = kwargs.pop("fl_weight", 1.0)
        dc_w = kwargs.pop("dc_weight", 1.0)
        return lambda logits, labels: dice_focal_loss(
            logits, labels, fl_w, dc_w, **kwargs)
    if name == "DiceLoss":
        return lambda logits, labels: multiclass_dice_loss(
            logits, labels, **kwargs)
    raise KeyError(f"unknown loss {name!r}")


LOSSES = {"DiceCELoss": dice_ce_loss, "DiceFocalLoss": dice_focal_loss,
          "DiceLoss": multiclass_dice_loss}
