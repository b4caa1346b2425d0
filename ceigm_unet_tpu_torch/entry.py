"""Entry points: the flagship model (MSVM-UNet gm_tiny, 9-class Synapse,
224x224, 1 channel) and an example input, as ``__graft_entry__.entry`` gives
them for the JAX package; its training step on a seeded synthetic batch,
the step ``tools/bench_train.py`` runs for the JAX package; and the legacy
MSVM-UNet (VSSM tiny_0230s encoder) with an example input, and its training
step on the same recipe; and the multi-process dry run
(``dryrun_multichip``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ceigm_unet_tpu_torch.models import (MSVMUNet, MSVMUNetLegacy,
                                         build_legacy_model, build_model)
from ceigm_unet_tpu_torch.train.config import SYNAPSE_CONFIG
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_train_step,
                                                  param_groups)
from ceigm_unet_tpu_torch.utils.debug import DebugGuards

# Synapse: 2211 training slices at batch 48, the last partial batch dropped
SYNAPSE_STEPS_PER_EPOCH = 2211 // 48


def entry(device: Union[str, torch.device] = "cuda",
          dtype: torch.dtype = torch.float32,
          seed: int = 0, quant_scan: bool = False, dwconv: str = "library",
          dysample_grouped: bool = True,
          debug: Optional[DebugGuards] = None
          ) -> Tuple[MSVMUNet, torch.Tensor]:
    """(model, x): the seeded flagship model in eval mode on ``device`` and
    a zero (1, 224, 224, 1) NHWC input there; ``model(x)`` gives logits.
    ``quant_scan`` (``CEIGM_QUANT``), ``dwconv`` (``CEIGM_BLDW``) and
    ``dysample_grouped`` (``CEIGM_GS_GROUP``) select the model's kernel
    routes, as ``build_model`` describes; with ``quant_scan`` (inference
    only) the model's parameters do not require grad, so ``model(x)`` runs
    with grad mode on or off. ``debug``: the debug guards the model runs
    (``utils/debug.py``; None, the default, runs none)."""
    model = build_model(num_classes=9, enc_name="gm_tiny", dtype=dtype,
                        device=device, seed=seed, quant_scan=quant_scan,
                        dwconv=dwconv, dysample_grouped=dysample_grouped,
                        debug=debug)
    return model, torch.zeros((1, 224, 224, 1), device=device)


def legacy_entry(device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: int = 0, debug: Optional[DebugGuards] = None
                 ) -> Tuple[MSVMUNetLegacy, torch.Tensor]:
    """(model, x) for the legacy MSVM-UNet (VSSM ``tiny_0230s`` encoder +
    the published decoder, 9 classes): the seeded model in eval mode on
    ``device`` and a zero (1, 224, 224, 1) NHWC input there.
    ``predict_volume`` serves it as it serves ``entry()``'s model;
    ``model(x)`` runs with grad mode on or off (every scan op on its path
    has a backward). ``debug`` as in :func:`entry`."""
    model = build_legacy_model(num_classes=9, enc_name="tiny_0230s",
                               dtype=dtype, device=device, seed=seed,
                               debug=debug)
    return model, torch.zeros((1, 224, 224, 1), device=device)


def synthetic_batch(batch: int, size: int = 224, num_classes: int = 9,
                    seed: int = 0, device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """A seeded batch with blob-shaped labels: per slice one ellipse per
    foreground class (later ones drawn over earlier ones) on background 0,
    and an image whose intensity follows the label plus noise, normalised
    as the data pipeline does ((x - 0.5) / 0.5). image (B, size, size, 1)
    float32, label (B, size, size) int64."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    label = np.zeros((batch, size, size), np.int64)
    for i in range(batch):
        for c in rng.permutation(np.arange(1, num_classes)):
            cy, cx = rng.uniform(0.15, 0.85, 2)
            ry, rx = rng.uniform(0.04, 0.18, 2)
            label[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = c
    image = label / float(num_classes) + rng.normal(0.0, 0.1, label.shape)
    image = ((image - 0.5) / 0.5).astype(np.float32)[..., None]
    return {"image": torch.from_numpy(image).to(device),
            "label": torch.from_numpy(label).to(device)}


def train_entry(device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32, batch: int = 48,
                seed: int = 0, dwconv: str = "library",
                dysample_grouped: bool = True
                ) -> Tuple[MSVMUNet, Callable, Dict[str, torch.Tensor]]:
    """(model, step, batch): the seeded gm_tiny model in training mode on
    ``device`` computing in ``dtype`` (parameters fp32), its training step
    with the Synapse recipe (AdamW 5e-4 / wd 1e-3, per-epoch cosine to 1e-6
    over 300 epochs, DiceCE 0.4/0.6), and one seeded synthetic batch.
    ``step(batch, freeze_encoder, generator)`` returns {"loss"}; the
    generator draws the decoder's stochastic-depth masks. ``dwconv`` and
    ``dysample_grouped`` select kernel routes as in ``build_model``
    (``quant_scan`` is inference-only)."""
    cfg = SYNAPSE_CONFIG
    model = build_model(num_classes=cfg.num_classes, enc_name=cfg.enc_name,
                        dtype=dtype, device=device, seed=seed, dwconv=dwconv,
                        dysample_grouped=dysample_grouped).train()
    optimizer = make_optimizer(param_groups(model), cfg.weight_decay)
    step = make_train_step(
        model, optimizer,
        cosine_lr(cfg.lr, cfg.eta_min, cfg.max_epochs,
                  SYNAPSE_STEPS_PER_EPOCH),
        ce_weight=cfg.ce_weight, dc_weight=cfg.dc_weight)
    return model, step, synthetic_batch(batch, cfg.img_size,
                                        cfg.num_classes, seed, device)


def legacy_train_entry(device: Union[str, torch.device] = "cuda",
                       dtype: torch.dtype = torch.float32, batch: int = 48,
                       seed: int = 0
                       ) -> Tuple[MSVMUNetLegacy, Callable,
                                  Dict[str, torch.Tensor]]:
    """(model, step, batch) as :func:`train_entry` gives them, for the
    legacy MSVM-UNet (VSSM ``tiny_0230s`` encoder + the published decoder,
    9 classes) in training mode on ``device`` computing in ``dtype``
    (parameters fp32), with the Synapse recipe of ``train_entry`` and one
    seeded synthetic batch. Every SS2D scans through ``sscan_dir`` (K10
    forward, K8 twice backward on the card)."""
    cfg = SYNAPSE_CONFIG
    model = build_legacy_model(num_classes=cfg.num_classes,
                               enc_name="tiny_0230s", dtype=dtype,
                               device=device, seed=seed).train()
    optimizer = make_optimizer(param_groups(model), cfg.weight_decay)
    step = make_train_step(
        model, optimizer,
        cosine_lr(cfg.lr, cfg.eta_min, cfg.max_epochs,
                  SYNAPSE_STEPS_PER_EPOCH),
        ce_weight=cfg.ce_weight, dc_weight=cfg.dc_weight)
    return model, step, synthetic_batch(batch, cfg.img_size,
                                        cfg.num_classes, seed, device)


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """The multi-process dry run (``parallel/dryrun.py``): n spawned ranks
    run data-parallel gm_tiny steps, the sequence-parallel selective scan
    and the tiny step's one-process-vs-n equivalence, with and without
    on-device augmentation. ``device`` "cuda" needs n cards (NCCL, one per
    rank) and raises with fewer; "cpu" runs gloo. Raises on any failed
    check."""
    from ceigm_unet_tpu_torch.parallel import dryrun
    dryrun.run(n, device)
