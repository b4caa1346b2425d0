"""Cross-scan / cross-merge layout transforms.

Counterpart of ``ceigm_unet_tpu/ops/cross_scan.py``: pure layout ops
(transpose, flip, reshape), no kernel. Directions: 1 row-major, 2
column-major, 3/4 those reversed. Channel-last (B, H, W, C) on the image
side, (B, C, L) on the scan side (the selective scan's (batch, dim, L)).
"""
from __future__ import annotations

import torch


def cross_scan_1d(x: torch.Tensor, direction: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, L) in the given scan direction (1..4)."""
    B, H, W, C = x.shape
    if direction in (2, 4):
        x = x.transpose(1, 2)                      # (B, W, H, C)
    xs = x.reshape(B, H * W, C).transpose(1, 2)    # (B, C, L)
    if direction in (3, 4):
        xs = xs.flip(-1)
    return xs


def cross_merge_1d(y: torch.Tensor, direction: int, H: int,
                   W: int) -> torch.Tensor:
    """(B, C, L) -> (B, H, W, C), inverse of :func:`cross_scan_1d`."""
    B, C, L = y.shape
    if L != H * W:
        raise ValueError(f"cross_merge_1d: L {L} != H*W {H * W}")
    if direction in (3, 4):
        y = y.flip(-1)
    if direction in (2, 4):
        return y.transpose(1, 2).reshape(B, W, H, C).transpose(1, 2)
    return y.transpose(1, 2).reshape(B, H, W, C)


def cross_scan_4d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, C, L): all four directions stacked."""
    return torch.stack([cross_scan_1d(x, k) for k in (1, 2, 3, 4)], dim=1)


def cross_merge_4d(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, C, L) -> (B, H, W, C): the four directions merged (summed)."""
    return sum(cross_merge_1d(ys[:, k - 1], k, H, W) for k in (1, 2, 3, 4))
