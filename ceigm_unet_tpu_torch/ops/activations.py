"""Exact-form GELU through the Abramowitz-Stegun 7.1.26 erf.

Counterpart of ``ceigm_unet_tpu/ops/activations.py``: the polynomial runs
in the INPUT dtype (bf16 in the bf16 regime), so the port rounds where the
JAX package rounds. ``F.gelu`` is not used: its bf16 result differs.
"""
from __future__ import annotations

import torch

_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911
_INV_SQRT2 = 0.7071067811865476


def _erf_as(t: torch.Tensor) -> torch.Tensor:
    s = torch.sign(t)
    t = torch.abs(t)
    u = 1.0 / (1.0 + _P * t)
    p = u * (_A[0] + u * (_A[1] + u * (_A[2] + u * (_A[3] + u * _A[4]))))
    return s * (1.0 - p * torch.exp(-t * t))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU(x) = x * (1 + erf(x / sqrt 2)) / 2, evaluated in x's dtype."""
    return x * (0.5 + 0.5 * _erf_as(x * _INV_SQRT2))
