"""Batch loader: PyTorch's ``DataLoader`` with the JAX package's batches.

Counterpart of ``ceigm_unet_tpu/data/loader.py``. The reference loads with a
torch ``DataLoader`` and 6 worker processes running imgaug on the CPU; so
does the port, and its batches are the JAX loader's, byte for byte:

- the order of epoch ``e`` is ``np.random.default_rng(seed + e)``'s shuffle
  of the indices, the last partial batch dropped with ``drop_last``;
- sample ``i`` of epoch ``e`` is augmented from
  ``np.random.default_rng(np.random.SeedSequence([seed, e, i]))``, so a
  batch does not depend on which worker read which sample. The batch
  sampler hands each worker ``(i, e)`` pairs: the epoch travels with the
  index, and persistent workers need no state of their own;
- a batch is ``{"image": (B, H, W, 1) float32, "label": (B, H, W) int32,
  "case_name": [...]}``, the image normalised by ``(x - 0.5) / 0.5``
  unless ``normalize=False`` (the on-device augmentation's raw feed);
- for data-parallel training, ``shard=(rank, world)`` loads only the
  rank's contiguous rows of each global batch: the same samples, made from
  the same generators, as one process loads for those rows.

Workers start by ``spawn`` and import only numpy, scipy, torch's CPU side
and the dataset's module: they never touch CUDA. As torch does with a
batch sampler, each batch is built by one worker, so an epoch's first
batch costs one worker's time for all its samples, while the other
workers build the following batches. Batches are pinned (``pin_memory``)
so that the copy to the card can run asynchronously.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.utils.data as tud


class _Samples(tud.Dataset):
    """Map-style view of a dataset: item ``(idx, epoch)`` is ``ds.get(idx,
    rng)`` with the generator of ``(seed, epoch, idx)``."""

    def __init__(self, ds, seed: int):
        self.ds, self.seed = ds, seed

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, item: Tuple[int, int]):
        idx, epoch = item
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        return self.ds.get(idx, rng)


class _EpochBatches(tud.Sampler):
    """Batches of ``(idx, epoch)`` in the JAX loader's order."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool, shard: Tuple[int, int] = (0, 1)):
        self.n, self.batch_size, self.shuffle = n, batch_size, shuffle
        self.seed, self.drop_last = seed, drop_last
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"{world} ranks do not divide the batch of "
                             f"{batch_size}")
        if world > 1 and not drop_last:
            raise ValueError("a sharded loader needs drop_last: the last "
                             "partial batch would leave ranks unequal or "
                             "empty")
        per = batch_size // world
        self.rows = slice(rank * per, (rank + 1) * per)
        self.epoch = 0

    def __len__(self):
        return (self.n // self.batch_size if self.drop_last
                else -(-self.n // self.batch_size))

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        limit = (self.n // self.batch_size * self.batch_size
                 if self.drop_last else self.n)
        for start in range(0, limit, self.batch_size):
            yield [(int(i), self.epoch)
                   for i in order[start:start + self.batch_size][self.rows]]


def collate(samples, normalize: bool = True) -> Dict:
    """Stack samples into a batch (see the module docstring). Slices of
    different shapes cannot be stacked: that raises a ``ValueError`` naming
    each case and its shape."""
    shapes = {np.shape(s["image"]) for s in samples} | \
        {np.shape(s["label"]) for s in samples}
    if len(shapes) > 1:
        raise ValueError(
            "a batch holds slices of different shapes, which cannot be "
            "stacked (zoom them to one size on the host, or batch cases of "
            "one shape): " + ", ".join(
                f"{s['case_name']} {np.shape(s['image'])}" for s in samples))
    images = np.stack([s["image"] for s in samples])[..., None]
    images = images.astype(np.float32)
    if normalize:
        images = (images - 0.5) / 0.5
    labels = np.stack([s["label"] for s in samples]).astype(np.int32)
    return {"image": torch.from_numpy(images),
            "label": torch.from_numpy(labels),
            "case_name": [s["case_name"] for s in samples]}


class DataLoader:
    """Iterates batches of ``dataset`` (an object with ``len`` and
    ``get(idx, rng)``) for the epoch last given to :meth:`set_epoch`.
    ``num_workers`` 0 loads in this process; more start that many
    ``spawn`` workers, kept across epochs. ``pin_memory`` pins each batch
    for an asynchronous copy to the card. ``batch_size`` is the global
    batch; ``shard=(rank, world)`` loads the rank's rows of it (with
    ``drop_last`` only, so that every rank holds a full share)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 6, seed: int = 0,
                 drop_last: bool = True, normalize: bool = True,
                 pin_memory: bool = True, shard: Tuple[int, int] = (0, 1)):
        self.ds = dataset
        self.batch_size = batch_size
        self.sampler = _EpochBatches(len(dataset), batch_size, shuffle, seed,
                                     drop_last, shard)
        workers = dict(multiprocessing_context="spawn",
                       persistent_workers=True) if num_workers > 0 else {}
        self.loader = tud.DataLoader(
            _Samples(dataset, seed), batch_sampler=self.sampler,
            num_workers=num_workers,
            collate_fn=functools.partial(collate, normalize=normalize),
            pin_memory=pin_memory, **workers)

    def __len__(self):
        return len(self.sampler)

    @property
    def epoch(self) -> int:
        return self.sampler.epoch

    def set_epoch(self, epoch: int):
        self.sampler.epoch = epoch

    def __iter__(self) -> Iterator[Dict]:
        return iter(self.loader)
