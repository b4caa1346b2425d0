"""LR schedule registry (reference gm-unet/lr_scheduler.py).

Counterpart of ``ceigm_unet_tpu/train/lr_scheduler.py``: the reference's
three torch schedulers, all stepped once per EPOCH, as ``schedule(step) ->
lr`` callables of the optimizer step, parameterised by ``steps_per_epoch``.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_annealing_lr(base_lr: float, steps_per_epoch: int,
                        t_max: int, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingLR (live config: T_max=300, eta_min=1e-6)."""
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / t_max))
    return schedule


def polynomial_lr(base_lr: float, steps_per_epoch: int,
                  total_iters: int = 5, power: float = 1.0) -> Schedule:
    """torch PolynomialLR: decay to 0 over ``total_iters`` epochs, constant
    afterwards."""
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        frac = min(max(epoch, 0), total_iters) / float(total_iters)
        return base_lr * (1.0 - frac) ** power
    return schedule


def cosine_annealing_warm_restarts(base_lr: float, steps_per_epoch: int,
                                   t_0: int, t_mult: int = 1,
                                   eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingWarmRestarts with integer ``t_mult``: the i-th
    cycle spans t_0 * t_mult**i epochs."""
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        # walk the completed cycles in integers (a float log of the cycle
        # count lands one short where the ratio rounds below an integer)
        t_cur, t_i = epoch, t_0
        if t_mult == 1:
            t_cur %= t_0
        else:
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t_cur / t_i))
    return schedule


LR_SCHEDULERS = {
    "PolynomialLR": polynomial_lr,
    "CosineAnnealingLR": cosine_annealing_lr,
    "CosineAnnealingWarmRestarts": cosine_annealing_warm_restarts,
}
