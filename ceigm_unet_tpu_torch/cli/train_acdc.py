"""ACDC training (reference gm-unet/train_acdc.py: 4 classes, batch 32, wd
1e-4, seed 1998, validation every 20 epochs then every 5); counterpart of
``ceigm_unet_tpu/cli/train_acdc.py``, with its flags and ``--device``.

Train slices are ``<data-dir>/train/*.npz``, validation volumes
``<data-dir>/test/*.npz``. With ``--device-aug`` a batch's slices must share
one shape (ACDC's do not in general): a batch of mixed shapes stops the
run with a ``ValueError`` naming its cases and their shapes.

    python -m ceigm_unet_tpu_torch.cli.train_acdc --data-dir D \\
        [--device cuda] [--max-steps N] ...

``--distributed`` trains data-parallel under torchrun, as
``cli/train_synapse.py`` describes.
"""
from __future__ import annotations

from ceigm_unet_tpu_torch.cli.train_synapse import parse_args
from ceigm_unet_tpu_torch.data.datasets import ACDCDataset
from ceigm_unet_tpu_torch.parallel.mesh import (close_data_parallel,
                                                init_data_parallel)
from ceigm_unet_tpu_torch.train.config import ACDC_CONFIG
from ceigm_unet_tpu_torch.train.loop import run_training


def load_val_volumes(data_dir: str, list_dir: str):
    ds = ACDCDataset(data_dir, split="test", list_dir=list_dir,
                     augment=False)
    return [ds[i] for i in range(len(ds))]


def main(argv=None):
    cfg, max_steps, device, distributed = parse_args(
        argv, ACDC_CONFIG, __doc__.split("\n\n")[0])
    if distributed:    # torchrun's group, at the size torchrun gave it
        init_data_parallel(None, device=device)
    train_ds = ACDCDataset(cfg.data_dir, "train", cfg.list_dir,
                           cfg.img_size, seed=cfg.seed,
                           augment=not cfg.device_aug,
                           keep_raw_size=cfg.device_aug)
    val = load_val_volumes(cfg.data_dir, cfg.list_dir)
    return run_training(cfg, train_ds, val, max_steps=max_steps,
                        device=device)


if __name__ == "__main__":
    try:
        main()
    finally:
        close_data_parallel()
