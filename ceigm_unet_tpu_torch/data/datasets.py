"""Dataset readers for the reference's on-disk formats and split lists
(gm-unet/dataset_synapse.py, dataset_acdc.py); counterpart of
``ceigm_unet_tpu/data/datasets.py``.

- Synapse train: one ``{case}_slice{N}.npz`` per slice, keys image/label;
  test_vol: one ``{case}.npy.h5`` volume per case (h5py), keys image/label.
- ACDC: ``.npz`` files under one directory per split, keys img/label;
  train and valid are zoomed to ``img_size``, test gives raw volumes.
- Split lists: one name per line in ``lists/lists_{Synapse,ACDC}``.

A sample is ``{"image", "label", "case_name"}``: image float32 (H, W) or
(D, H, W), label float32, as the reference's tensors before its
torchvision transforms; the normalisation (x - 0.5) / 0.5 belongs to the
model's caller. Train-split augmentation is not ported yet: asking for it
raises rather than giving unaugmented samples.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ceigm_unet_tpu_torch.ops.resize import zoom_host


def _resolve_list_dir(list_dir: str) -> str:
    """A split-list directory as given (relative to the cwd) if it exists,
    else the same path under the repository root, where the official splits
    are vendored (``lists/lists_{Synapse,ACDC}``), so that runs find them
    from any cwd. A path that leaves the root is returned as given."""
    if os.path.isdir(list_dir):
        return list_dir
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # only an explicit "./" is stripped: lstrip("./") would also eat a
    # "../" and map an escaping path onto the vendored lists
    rel = list_dir[2:] if list_dir.startswith("./") else list_dir
    cand = os.path.normpath(os.path.join(repo_root, rel))
    if not (cand == repo_root or cand.startswith(repo_root + os.sep)):
        return list_dir
    return cand if os.path.isdir(cand) else list_dir


def _read_list(list_dir: str, split: str) -> list[str]:
    with open(os.path.join(_resolve_list_dir(list_dir),
                           split + ".txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _zoom_pair(image, label, size):
    h, w = image.shape
    if h != size or w != size:
        image = zoom_host(image, (size, size), order=3)
        label = zoom_host(label, (size, size), order=0)
    return image, label


def make_label_pyramid(label: np.ndarray, scales) -> list:
    """Deep-supervision labels (reference resize_mask /
    deep_supervision_scales, dataset_synapse.py:14-16,108-109): the label
    zoomed with order 0 to each scale."""
    h, w = label.shape
    return [label if tuple(s) == (1, 1)
            else zoom_host(label, (round(h * s[0]), round(w * s[1])),
                           order=0)
            for s in scales]


class _SplitDataset:
    def __init__(self, base_dir: str, split: str, list_dir: str,
                 img_size: int, augment: bool, seed: int,
                 deep_supervision_scales, keep_raw_size: bool):
        """``keep_raw_size``: train slices at their source resolution, with
        no host zoom. ``seed`` seeds the train split's augmentation in the
        JAX package; it is accepted and unused until that is ported."""
        if augment and split == "train":
            raise NotImplementedError(
                "train-split augmentation (data/augment.py and its native "
                "warp) is not ported yet (ROADMAP A5); pass augment=False")
        self.base_dir = base_dir
        self.split = split
        self.img_size = img_size
        self.samples = _read_list(list_dir, split)
        self.deep_supervision_scales = deep_supervision_scales
        self.keep_raw_size = keep_raw_size

    def __len__(self):
        return len(self.samples)

    def _sample(self, image, label, name) -> Dict[str, Any]:
        out = {"image": image, "label": label, "case_name": name}
        if self.deep_supervision_scales is not None:
            out["label_pyramid"] = make_label_pyramid(
                label, self.deep_supervision_scales)
        return out


class SynapseDataset(_SplitDataset):
    def __init__(self, base_dir: str, split: str = "train",
                 list_dir: str = "./lists/lists_Synapse",
                 img_size: int = 224, augment: bool = True,
                 seed: int = 0, deep_supervision_scales=None,
                 keep_raw_size: bool = False):
        super().__init__(base_dir, split, list_dir, img_size, augment, seed,
                         deep_supervision_scales, keep_raw_size)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        name = self.samples[idx]
        if self.split == "train":
            with np.load(os.path.join(self.base_dir, name + ".npz")) as data:
                image = np.asarray(data["image"], np.float32)
                label = np.asarray(data["label"], np.float32)
            if not self.keep_raw_size:
                image, label = _zoom_pair(image, label, self.img_size)
        else:
            import h5py
            path = os.path.join(self.base_dir, f"{name}.npy.h5")
            with h5py.File(path, "r") as f:
                image = np.asarray(f["image"][:], np.float32)
                label = np.asarray(f["label"][:], np.float32)
        return self._sample(image, label, name)


class ACDCDataset(_SplitDataset):
    def __init__(self, base_dir: str, split: str = "train",
                 list_dir: str = "./lists/lists_ACDC",
                 img_size: int = 224, augment: bool = True,
                 seed: int = 0, deep_supervision_scales=None,
                 keep_raw_size: bool = False):
        super().__init__(base_dir, split, list_dir, img_size, augment, seed,
                         deep_supervision_scales, keep_raw_size)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        name = self.samples[idx]
        with np.load(os.path.join(self.base_dir, self.split, name)) as data:
            image = np.asarray(data["img"], np.float32)
            label = np.asarray(data["label"], np.float32)
        if self.split in ("train", "valid") and not self.keep_raw_size:
            image, label = _zoom_pair(image, label, self.img_size)
        return self._sample(image, label, name)
