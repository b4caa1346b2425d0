"""Host-side training loop.

Counterpart of ``ceigm_unet_tpu/train/loop.py``, which replaces the
reference's LightningModule + Trainer (gm-unet/train_synapse.py:31-223)
with an explicit loop, on one card:

- epochs with the hard stop (epoch 250 of 300) and the encoder frozen for
  the first ``freeze_encoder_epochs`` (10);
- validation every ``val_every_early`` epochs until ``val_switch_epoch``,
  then every ``val_every_late``: each volume's mean Dice by
  ``eval_single_volume``;
- checkpoints (Lightning's layout, ``convert/checkpoint.py``): ``-best`` on
  a better mean validation Dice, ``-last`` after every epoch;
- early stopping on the mean train loss with patience 1500 (in effect
  never, kept as the reference has it);
- logging to a file and stderr, and one JSONL row of scalars per epoch.

An fp32 run trains with TF32 off (``no_tf32``), the reference's precision.

Data parallelism: with a process group active (``parallel.init_data_parallel``,
one process per card), every rank builds the same model from the seed,
loads its rows of each global batch (the loader's ``shard``) and steps on
them (``train/trainstep.py`` averages the gradients). Rank 0 alone
validates and writes the log file, the history and the checkpoints; its
early-stop and hard-stop decisions are broadcast, so every rank leaves the
loop at the same epoch and none waits in a collective for a rank that has
left. A resume reads the same file on every rank.

The per-step losses stay on the card; their mean is read once per epoch,
so the host never waits on the card inside an epoch.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ceigm_unet_tpu_torch.convert.checkpoint import (load_checkpoint,
                                                     save_checkpoint,
                                                     strip_lightning_prefix)
from ceigm_unet_tpu_torch.convert.torch_import import (
    remap_pretrained_groupmamba_keys)
from ceigm_unet_tpu_torch.data.loader import DataLoader
from ceigm_unet_tpu_torch.eval.volume import eval_single_volume
from ceigm_unet_tpu_torch.models import MSVMUNet, build_model
from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.train.config import TrainConfig
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_train_step,
                                                  param_groups)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def setup_logger(log_dir: str, name: str) -> logging.Logger:
    """Logger ``ceigm.<name>`` writing to ``<log_dir>/<name>.log`` and to
    stderr; a second call with the same name replaces its handlers."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"ceigm.{name}")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


@contextlib.contextmanager
def no_tf32():
    """fp32 matrix products and convolutions in full fp32 (TF32 off) inside
    the block; PyTorch's settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class MetricHistory:
    """Append-only JSONL history: one object of scalars per epoch, readable
    with ``pd.read_json(path, lines=True)``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def append(self, **scalars):
        with open(self.path, "a") as f:
            f.write(json.dumps(scalars) + "\n")


def should_validate(epoch: int, cfg: TrainConfig) -> bool:
    if epoch < cfg.val_switch_epoch:
        return (epoch + 1) % cfg.val_every_early == 0
    return (epoch + 1) % cfg.val_every_late == 0


def run_training(cfg: TrainConfig, train_ds, val_volumes=None,
                 max_steps: Optional[int] = None,
                 logger: Optional[logging.Logger] = None,
                 resume_from: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[MSVMUNet, Callable]:
    """Train gm-unet on ``train_ds`` (an object with ``len`` and
    ``get(idx, rng)``, as ``data/datasets.py`` gives) on ``device`` (the
    card unless the caller asks for ``"cpu"``); with ``compute_dtype``
    float32, TF32 is off throughout. ``val_volumes``: iterable
    of {"image": (D, H, W), "label": (D, H, W), "case_name"}.
    ``resume_from``: a ``-last`` / ``-best`` file of an earlier run. Resume
    restores what the JAX loop restores: the parameters, the BatchNorm
    buffers, the optimizer's step count (``step.count``, which the LR
    schedule reads) and the epoch after the saved one; the AdamW moments
    restart at zero, and so does the loop's own step count (``max_steps``,
    the rows' ``step``). With a data-parallel group active (see the module
    docstring), ``cfg.batch_size`` is the global batch and ``device`` the
    kind of device: each rank trains on the one ``init_data_parallel``
    set. Returns the model and its train step."""
    with (no_tf32() if cfg.compute_dtype == "float32"
          else contextlib.nullcontext()):
        return _run_training(cfg, train_ds, val_volumes, max_steps, logger,
                             resume_from, mesh.rank_device(device))


def _quiet_logger(name: str) -> logging.Logger:
    """A logger that writes nothing (the ranks other than 0)."""
    logger = logging.getLogger(f"ceigm.{name}.quiet")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def _run_training(cfg, train_ds, val_volumes, max_steps, logger,
                  resume_from, device):
    rank, world = mesh.rank_and_size()
    lead = rank == 0
    if lead:
        logger = logger or setup_logger(cfg.log_dir, cfg.name)
    else:
        logger = _quiet_logger(cfg.name)
    model = build_model(num_classes=cfg.num_classes, enc_name=cfg.enc_name,
                        dtype=DTYPES[cfg.compute_dtype], device=device,
                        seed=cfg.seed)

    # with device augmentation the raw slices reach the card as they are:
    # the step augments, zooms and normalises them
    loader = DataLoader(train_ds, cfg.batch_size, shuffle=True,
                        num_workers=cfg.num_workers, seed=cfg.seed,
                        normalize=not cfg.device_aug,
                        pin_memory=device.type == "cuda",
                        shard=(rank, world))
    steps_per_epoch = max(1, len(loader))
    lr_sched = cosine_lr(cfg.lr, cfg.eta_min, cfg.max_epochs,
                         steps_per_epoch)
    optimizer = make_optimizer(param_groups(model), cfg.weight_decay)
    step = make_train_step(
        model, optimizer, lr_sched, cfg.ce_weight, cfg.dc_weight,
        device_aug_size=cfg.img_size if cfg.device_aug else None,
        aug_seed=cfg.seed)
    history = MetricHistory(
        os.path.join(cfg.log_dir, f"{cfg.name}.metrics.jsonl")) if lead \
        else None

    if cfg.pretrained_encoder:
        load_pretrained_encoder(model, cfg.pretrained_encoder, logger)

    start_epoch = 0
    if resume_from:
        payload = load_checkpoint(resume_from)
        model.load_state_dict(strip_lightning_prefix(payload["state_dict"]),
                              strict=True)
        step.count = int(payload.get("global_step", 0))
        start_epoch = int(payload.get("epoch", -1)) + 1
        logger.info(f"resumed from {resume_from} at epoch {start_epoch}")

    # stochastic depth draws from one generator on the card
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    best_dice = -1.0
    best_loss = float("inf")
    patience_count = 0
    global_step = 0
    stop = False

    for epoch in range(start_epoch, cfg.max_epochs):
        # the reference's hard stop
        if mesh.broadcast_flag(epoch >= cfg.stop_epoch, device):
            logger.info(f"hard stop at epoch {epoch}")
            break
        loader.set_epoch(epoch)
        freeze = epoch < cfg.freeze_encoder_epochs
        losses = []
        t0 = time.time()
        for batch in loader:
            b = {k: batch[k].to(device, non_blocking=True)
                 for k in ("image", "label")}
            losses.append(step(b, freeze_encoder=freeze,
                               generator=gen)["loss"])
            global_step += 1
            if max_steps is not None and global_step >= max_steps:
                stop = True
                break
        mean_loss = (torch.stack(losses).float().mean().item() if losses
                     else 0.0)
        epoch_time = time.time() - t0
        logger.info(f"epoch {epoch} mean_train_loss {mean_loss:.4f} "
                    f"({epoch_time:.1f}s, {len(losses)} steps)")
        row = {"epoch": epoch, "step": global_step,
               "mean_train_loss": mean_loss,
               "lr": float(lr_sched(global_step)),
               "epoch_time_s": round(epoch_time, 3),
               "slices_per_s": round(
                   len(losses) * cfg.batch_size / max(epoch_time, 1e-9), 2)}

        # EarlyStopping as the reference configures it (patience 1500)
        if mean_loss < best_loss:
            best_loss = mean_loss
            patience_count = 0
        else:
            patience_count += 1
            if patience_count >= 1500:
                logger.info("early stop (train loss plateau)")
                stop = True

        if lead:
            if val_volumes is not None and should_validate(epoch, cfg):
                model.eval()
                dices = []
                for vol in val_volumes:
                    metric = eval_single_volume(
                        model, vol["image"], vol["label"], cfg.num_classes,
                        (cfg.img_size, cfg.img_size))
                    per_class = [float(np.mean(v))
                                 for v in metric["dice"].values()]
                    dices.append(float(np.mean(per_class)))
                val_dice = float(np.mean(dices)) if dices else 0.0
                logger.info(f"epoch {epoch} val_mean_dice {val_dice:.4f}")
                row["val_mean_dice"] = val_dice
                if val_dice > best_dice:
                    best_dice = val_dice
                    save_checkpoint(cfg.ckpt_dir, f"{cfg.name}-best", model,
                                    step.count, epoch,
                                    {"val_mean_dice": val_dice})
            history.append(**row)
            save_checkpoint(cfg.ckpt_dir, f"{cfg.name}-last", model,
                            step.count, epoch)
        if mesh.broadcast_flag(stop, device):
            break
    return model, step


def load_pretrained_encoder(model: MSVMUNet, ckpt_path: str,
                            logger: logging.Logger) -> None:
    """Load the encoder from an upstream GroupMamba classification
    checkpoint (reference model/gm/__init__.py:60-86): its keys remapped
    (``convert/torch_import.py``), the classifier's head and final norm
    dropped. As the JAX package's converter reads it, every key the encoder
    holds must be present (a missing one raises ``KeyError`` naming it; a
    BatchNorm's ``num_batches_tracked``, which the JAX converter does not
    read, may be absent), keys the encoder lacks are not loaded (their
    names are logged), and a tensor of another shape raises. The decoder is
    not touched."""
    logger.info(f"loading pretrained encoder: {ckpt_path}")
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = remap_pretrained_groupmamba_keys(raw.get("state_dict", raw))
    encoder = model.encoder.gm_encoder
    own = encoder.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"pretrained encoder checkpoint lacks {missing}")
    extra = sorted(k for k in sd if k not in own)
    if extra:
        logger.info(f"pretrained encoder: not loaded, the encoder lacks "
                    f"{extra}")
    encoder.load_state_dict({k: v for k, v in sd.items() if k in own},
                            strict=False)
