"""Seeded weights for a state dict of the served MSVM-UNet, made on the
device in a few large draws.

A frozen copy of the served package's initialisation scheme, by parameter
name and shape:

- Linear weights (2-D): truncated normal, std 0.02, cut at +-2 std;
- convolution weights (4-D): DySample's offset convs normal(1e-3); other
  decoder convs outside the Front blocks normal(0.02); every other conv
  normal(sqrt(2 / fan_out)), fan_out = kh * kw * out / groups (depthwise
  when a kernel has one input channel per group);
- SSM bundles: x_proj U(+-D^-1/2), dt_proj U(+-R^-1/2), the dt bias the
  softplus inverse of a log-uniform dt in [1e-3, 0.1] (at least 1e-4),
  A_logs log(1..N), Ds ones;
- norms weight 1, every bias 0, BatchNorm statistics (0, 1), skip_scale 1,
  the fusion gates 0.

The values come from a generator seeded with the seed, on ``device``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]

LOG_DT_MIN, LOG_DT_MAX = math.log(1e-3), math.log(0.1)
TRUNC = 2.0                      # truncation of the Linear init, in stds


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs, ...)."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def _conv_std(name: str, shape) -> float:
    out, in_per_group, kh, kw = shape
    if ".offset." in name:
        return 1e-3
    if name.startswith("decoder.") and ".cm_layer." not in name:
        return 0.02
    fan_out = kh * kw * (1 if in_per_group == 1 else out)
    return math.sqrt(2.0 / fan_out)


def _kind(name: str, shape) -> Tuple[str, float]:
    """(how the leaf is drawn, its scale)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked" or leaf == "running_mean":
        return "zeros", 0.0
    if leaf in ("running_var", "Ds", "skip_scale"):
        return "ones", 0.0
    if leaf == "A_logs":
        return "a_logs", 0.0
    if leaf == "x_proj_weight":
        return "uniform", shape[-1] ** -0.5
    if leaf == "dt_projs_weight":
        return "uniform", shape[-1] ** -0.5
    if leaf == "dt_projs_bias":
        return "dt_bias", 0.0
    if leaf in ("bias", "x"):
        return "zeros", 0.0
    if leaf == "weight" and len(shape) == 1:
        return "ones", 0.0
    if leaf == "weight" and len(shape) == 2:
        return "trunc_normal", 0.02
    if leaf == "weight" and len(shape) == 4:
        return "normal", _conv_std(name, shape)
    raise ValueError(f"no init rule for {name} {tuple(shape)}")


def make_state(shapes: Shapes, seed: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """A state dict with the given names, shapes and dtypes, drawn from
    ``seed`` on ``device``: one normal and one uniform draw for all
    leaves."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 0))
    kinds = {k: _kind(k, s) for k, (s, _) in shapes.items()}
    numel = {k: math.prod(s) for k, (s, _) in shapes.items()}
    by = lambda *ks: [k for k in shapes if kinds[k][0] in ks]
    normal, uniform = by("normal"), by("trunc_normal", "uniform", "dt_bias")
    z = torch.randn(sum(numel[k] for k in normal), generator=gen,
                    device=device)
    u = torch.rand(sum(numel[k] for k in uniform), generator=gen,
                   device=device)
    scale = lambda ks: torch.repeat_interleave(
        torch.tensor([kinds[k][1] for k in ks], device=device),
        torch.tensor([numel[k] for k in ks], device=device))
    if normal:
        z *= scale(normal)
    # the uniform draw becomes each leaf's distribution in place
    out, offset = {}, 0
    lo = 0.5 * math.erfc(TRUNC / math.sqrt(2.0))       # Phi(-2)
    for k in uniform:
        v = u[offset:offset + numel[k]]
        offset += numel[k]
        kind, s = kinds[k]
        if kind == "trunc_normal":
            v.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_() \
                .mul_(s * math.sqrt(2.0))
        elif kind == "uniform":
            v.mul_(2.0 * s).sub_(s)
        else:
            dt = torch.exp(v * (LOG_DT_MAX - LOG_DT_MIN) + LOG_DT_MIN) \
                .clamp_min(1e-4)
            v.copy_(dt + torch.log(-torch.expm1(-dt)))
        out[k] = v
    offset = 0
    for k in normal:
        out[k] = z[offset:offset + numel[k]]
        offset += numel[k]
    state = {}
    for k, (shape, dtype) in shapes.items():
        kind = kinds[k][0]
        if kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "a_logs":
            n = shape[-1]
            t = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(shape)
        else:
            t = out[k].view(shape)
        state[k] = t.to(dtype)
    return state
