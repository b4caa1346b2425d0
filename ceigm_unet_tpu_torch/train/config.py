"""Typed training configuration.

Counterpart of ``ceigm_unet_tpu/train/config.py``, with the same presets:

- Synapse (gm-unet/train_synapse.py): 9 classes, batch 48, AdamW lr 5e-4 /
  wd 1e-3, cosine T_max 300 eta_min 1e-6, DiceCE 0.4/0.6, max 300 epochs
  with a hard stop at 250, encoder frozen 10 epochs, val every 150 epochs
  then every 5 after 150, seed 42.
- ACDC (gm-unet/train_acdc.py): 4 classes, batch 32, wd 1e-4, val every 20
  until 250 then every 5, seed 1998.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    name: str = "synapse"
    num_classes: int = 9
    img_size: int = 224
    batch_size: int = 48
    lr: float = 5e-4
    weight_decay: float = 1e-3
    eta_min: float = 1e-6
    max_epochs: int = 300
    stop_epoch: int = 250          # reference hard stop
    freeze_encoder_epochs: int = 10
    ce_weight: float = 0.4
    dc_weight: float = 0.6
    seed: int = 42
    enc_name: str = "gm_tiny"
    val_every_early: int = 150     # cadence before val_switch_epoch
    val_every_late: int = 5
    val_switch_epoch: int = 150
    data_dir: str = "./data/Synapse"
    list_dir: str = "./lists/lists_Synapse"
    log_dir: str = "./logs"
    ckpt_dir: str = "./checkpoints"
    pretrained_encoder: Optional[str] = None
    num_workers: int = 6
    compute_dtype: str = "float32"  # the reference trains in fp32
    device_aug: bool = False


SYNAPSE_CONFIG = TrainConfig()

ACDC_CONFIG = TrainConfig(
    name="acdc", num_classes=4, batch_size=32, weight_decay=1e-4,
    seed=1998, val_every_early=20, val_switch_epoch=250, val_every_late=5,
    data_dir="./data/ACDC", list_dir="./lists/lists_ACDC")
