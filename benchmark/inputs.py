"""Seeded inputs, made on the device: a pool of CT-like 512x512 slices that
volumes are cut from, the order of the volumes' depths, and synthetic
training batches."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.weights import stream_seed


def volume_pool(n: int, hw: Sequence[int], seed: int, device: torch.device,
                chunk: int = 64) -> np.ndarray:
    """(n, H, W) float32 host array of smooth CT-like slices in [0, 1]: a
    16 x 16 grid of uniform levels, each spread over an (H/16, W/16) block,
    plus normal noise of std 0.05, clipped (the smooth generator of the
    repository's chip smoke run). Made on the device in chunks and copied
    into one host array."""
    H, W = hw
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    pool = np.empty((n, H, W), np.float32)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        coarse = torch.rand((m, 16, 16), generator=gen, device=device)
        vol = coarse.repeat_interleave(H // 16, 1).repeat_interleave(W // 16,
                                                                     2)
        vol = (vol + 0.05 * torch.randn(vol.shape, generator=gen,
                                        device=device)).clamp_(0.0, 1.0)
        pool[i:i + m] = vol.cpu().numpy()
    return pool


def depth_set(low: int, high: int, count: int) -> List[int]:
    """``count`` depths spread evenly over [low, high]: every seed serves
    the same set, in its own order."""
    return [int(round(d)) for d in np.linspace(low, high, count)]


class VolumeOrder:
    """Volumes in the order one seed serves them: the depth set shuffled
    anew for every pass, each volume a contiguous run of the pool starting
    at a seeded slice."""

    def __init__(self, depths: Sequence[int], pool_slices: int, seed: int):
        self.depths = list(depths)
        self.pool_slices = pool_slices
        self.rng = np.random.default_rng(stream_seed(seed, 2))
        self.pending: List[int] = []

    def next(self):
        """(first pool slice, depth) of the next volume."""
        if not self.pending:
            self.pending = list(self.rng.permutation(self.depths))
        d = int(self.pending.pop())
        start = int(self.rng.integers(0, self.pool_slices - d + 1))
        return start, d


def train_batches(n: int, batch: int, size: int, num_classes: int,
                  seed: int, device: torch.device) -> List[Dict]:
    """n batches of distinct synthetic slices: per slice one ellipse per
    foreground class, in a seeded order, later ones drawn over earlier ones
    on background 0; the image is label / classes plus normal noise of std
    0.1, normalised as the data pipeline does ((x - 0.5) / 0.5). image (B,
    size, size, 1) float32, label (B, size, size) int64."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 4))
    k = num_classes - 1
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    out = []
    for _ in range(n):
        order = torch.argsort(torch.rand((batch, k), generator=gen,
                                         device=device), dim=1) + 1
        c = 0.15 + 0.7 * torch.rand((batch, k, 2), generator=gen,
                                    device=device)
        r = 0.04 + 0.14 * torch.rand((batch, k, 2), generator=gen,
                                     device=device)
        label = torch.zeros((batch, size, size), dtype=torch.int64,
                            device=device)
        for j in range(k):
            dy = (ax[None, :, None] - c[:, j, 0, None, None]) \
                / r[:, j, 0, None, None]
            dx = (ax[None, None, :] - c[:, j, 1, None, None]) \
                / r[:, j, 1, None, None]
            label = torch.where(dy * dy + dx * dx < 1,
                                order[:, j, None, None], label)
        image = label.float() / num_classes + 0.1 * torch.randn(
            label.shape, generator=gen, device=device)
        out.append({"image": ((image - 0.5) / 0.5)[..., None],
                    "label": label})
    return out
