"""Test-set inference (reference gm-unet/inference.py); counterpart of
``ceigm_unet_tpu/cli/inference.py``.

Each case is served whole by ``predict_volume`` on the model's device and
scored on the host with dice, hd95, jaccard and asd (medpy semantics);
per-case tables are averaged per class (``nanmean`` over cases), then
globally (``nanmean`` over classes), and logged. Synapse has 9 classes and
reads ``test_vol`` ``.npy.h5`` volumes; ACDC has 4 and reads ``test``
``.npz`` files. Checkpoints are Lightning ``.ckpt`` / ``.pth`` files. The
model serves in fp32, with TF32 off for its matrix products and
convolutions while a split is scored.

    python -m ceigm_unet_tpu_torch.cli.inference acdc --ckpt best.ckpt \\
        --data-dir data/ACDC [--list-dir ...] [--log-dir ./logs] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from ceigm_unet_tpu_torch.convert.checkpoint import load_model
from ceigm_unet_tpu_torch.eval.metrics import (CLASS_COLOR_MAPS, dice_binary,
                                               jaccard_binary,
                                               surface_metrics)
from ceigm_unet_tpu_torch.eval.volume import predict_volume
from ceigm_unet_tpu_torch.train.loop import no_tf32, setup_logger

METRICS = ("dice", "hd95", "jaccard", "asd")


def test_single_volume(model: torch.nn.Module, image, label,
                       num_classes: int, patch_size=(224, 224)
                       ) -> Dict[str, Dict[str, float]]:
    """Reference test_single_volume (inference.py:38-112):
    ``{class_name: {dice, jaccard, hd95, asd}}`` of one case."""
    pred = predict_volume(model, np.asarray(image), patch_size)
    out = {}
    for cls_name, (idx, _) in CLASS_COLOR_MAPS[num_classes].items():
        p = pred == idx
        g = np.asarray(label) == idx
        m = {"dice": dice_binary(p, g), "jaccard": jaccard_binary(p, g)}
        m.update(surface_metrics(p, g))
        out[cls_name] = m
    return out


def run_inference(dataset, model: torch.nn.Module, num_classes: int, logger,
                  patch_size=(224, 224)):
    """Reference inference() aggregation (inference.py:114-173): returns
    (per-class means, global means) and logs each case's mean dice, each
    class's means and the ``global:`` line."""
    per_class = defaultdict(lambda: defaultdict(list))
    for i in range(len(dataset)):
        sample = dataset[i]
        metrics = test_single_volume(model, sample["image"], sample["label"],
                                     num_classes, patch_size)
        mean_dice = float(np.mean([m["dice"] for m in metrics.values()]))
        logger.info(f"case {sample['case_name']}: mean_dice {mean_dice:.4f}")
        for cls_name, m in metrics.items():
            for k, v in m.items():
                per_class[cls_name][k].append(v)

    summary = {}
    for cls_name, md in per_class.items():
        summary[cls_name] = {k: float(np.nanmean(v)) for k, v in md.items()}
        logger.info(f"class {cls_name}: " + " ".join(
            f"{k} {v:.4f}" for k, v in summary[cls_name].items()))
    global_means = {k: float(np.nanmean([summary[c][k] for c in summary]))
                    for k in METRICS}
    logger.info("global: " + " ".join(
        f"{k} {v:.4f}" for k, v in global_means.items()))
    return summary, global_means


def test_synapse(ckpt: str, data_dir: str, list_dir: str, log_dir: str,
                 device: str = "cuda"):
    """Synapse ``test_vol`` (9 classes) in fp32 with TF32 off, logged to
    ``<log_dir>/inference_synapse.log``."""
    from ceigm_unet_tpu_torch.data.datasets import SynapseDataset
    logger = setup_logger(log_dir, "inference_synapse")
    ds = SynapseDataset(data_dir, "test_vol", list_dir, augment=False)
    with no_tf32():
        return run_inference(ds, load_model(ckpt, 9, device=device), 9,
                             logger)


def test_acdc(ckpt: str, data_dir: str, list_dir: str, log_dir: str,
              device: str = "cuda"):
    """ACDC ``test`` (4 classes) in fp32 with TF32 off, logged to
    ``<log_dir>/inference_acdc.log``."""
    from ceigm_unet_tpu_torch.data.datasets import ACDCDataset
    logger = setup_logger(log_dir, "inference_acdc")
    ds = ACDCDataset(data_dir, "test", list_dir, augment=False)
    with no_tf32():
        return run_inference(ds, load_model(ckpt, 4, device=device), 4,
                             logger)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dataset", choices=["synapse", "acdc"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--list-dir", default=None)
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: cuda)")
    a = p.parse_args(argv)
    if a.dataset == "synapse":
        return test_synapse(a.ckpt, a.data_dir,
                            a.list_dir or "./lists/lists_Synapse", a.log_dir,
                            a.device)
    return test_acdc(a.ckpt, a.data_dir, a.list_dir or "./lists/lists_ACDC",
                     a.log_dir, a.device)


if __name__ == "__main__":
    main()
