"""Synapse training (reference gm-unet/train_synapse.py); counterpart of
``ceigm_unet_tpu/cli/train_synapse.py``, with its flags and ``--device``.

The reference hard-codes its paths; here they are flags with its defaults.
Train slices are ``<data-dir>/train_npz/*.npz``, validation volumes
``<data-dir>/test_vol_h5/*.npy.h5`` (read with h5py).

    python -m ceigm_unet_tpu_torch.cli.train_synapse --data-dir D \\
        [--device cuda] [--max-steps N] [--device-aug] ...

Data-parallel, one process per card, under torchrun (``--batch-size`` is
the global batch, which the ranks must divide):

    torchrun --standalone --nproc_per_node=N \\
        -m ceigm_unet_tpu_torch.cli.train_synapse --distributed --data-dir D
"""
from __future__ import annotations

import argparse
import dataclasses

from ceigm_unet_tpu_torch.data.datasets import SynapseDataset
from ceigm_unet_tpu_torch.parallel.mesh import (close_data_parallel,
                                                init_data_parallel)
from ceigm_unet_tpu_torch.train.config import SYNAPSE_CONFIG, TrainConfig
from ceigm_unet_tpu_torch.train.loop import run_training


def load_val_volumes(data_dir: str, list_dir: str):
    ds = SynapseDataset(data_dir, split="test_vol", list_dir=list_dir,
                        augment=False)
    return [ds[i] for i in range(len(ds))]


def parse_args(argv, cfg: TrainConfig, description: str):
    """The training CLIs' flags, defaults from ``cfg``. Returns (config,
    max_steps, device, distributed)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data-dir", default=cfg.data_dir)
    p.add_argument("--list-dir", default=cfg.list_dir)
    p.add_argument("--log-dir", default=cfg.log_dir)
    p.add_argument("--ckpt-dir", default=cfg.ckpt_dir)
    p.add_argument("--batch-size", type=int, default=cfg.batch_size)
    p.add_argument("--max-epochs", type=int, default=cfg.max_epochs)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=cfg.seed)
    p.add_argument("--pretrained-encoder", default=None)
    p.add_argument("--compute-dtype", default=cfg.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--device-aug", action="store_true",
                   help="augment on the card inside the train step (raw "
                        "slices -> augmentation and zoom in one gather, "
                        "data/device_aug.py)")
    p.add_argument("--device", default="cuda",
                   help="where the model trains (default: cuda)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training in torchrun's process group "
                        "(one rank per card; NCCL on the card, gloo with "
                        "--device cpu)")
    a = p.parse_args(argv)
    cfg = dataclasses.replace(
        cfg, data_dir=a.data_dir, list_dir=a.list_dir, log_dir=a.log_dir,
        ckpt_dir=a.ckpt_dir, batch_size=a.batch_size,
        max_epochs=a.max_epochs, seed=a.seed,
        pretrained_encoder=a.pretrained_encoder,
        compute_dtype=a.compute_dtype, device_aug=a.device_aug)
    return cfg, a.max_steps, a.device, a.distributed


def main(argv=None):
    cfg, max_steps, device, distributed = parse_args(
        argv, SYNAPSE_CONFIG, __doc__.split("\n\n")[0])
    if distributed:    # torchrun's group, at the size torchrun gave it
        init_data_parallel(None, device=device)
    train_ds = SynapseDataset(cfg.data_dir + "/train_npz", "train",
                              cfg.list_dir, cfg.img_size, seed=cfg.seed,
                              augment=not cfg.device_aug,
                              keep_raw_size=cfg.device_aug)
    val = load_val_volumes(cfg.data_dir + "/test_vol_h5", cfg.list_dir)
    return run_training(cfg, train_ds, val, max_steps=max_steps,
                        device=device)


if __name__ == "__main__":
    try:
        main()
    finally:
        close_data_parallel()
