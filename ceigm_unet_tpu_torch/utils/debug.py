"""Debug guards: nan/inf detection and capture of intermediate tensors.

Counterpart of ``ceigm_unet_tpu/utils/debug.py`` (the reference's
``check_nan_inf``, gm-unet/model/gm/csms6s.py:231-235, and its
``__DEBUG__`` tensor capture, gm-unet/model/gm/ss2d.py:488-493). The JAX
package switches them on with the ``CEIGM_DEBUG_NANCHECK`` /
``CEIGM_DEBUG_CAPTURE`` environment variables; here a model is built with
a :class:`DebugGuards` (``build_model(debug=...)``, ``entry(debug=...)``),
which its scan modules hold. A model built without one (the default) runs
no guard: no op is added and the host never waits on the device.

The guards sit where the JAX package has them, with its tags:

- ``ssm_scan_core.ys``, and the capture ``ssm_scan_core`` of us, dts, Bs,
  Cs and ys: ``models/ss2d.py`` :func:`ssm_scan_core` (``SS2D`` at d_state
  other than 1);
- ``quad_ssm_nhwc.y``: ``SS2D``'s directional scans at d_state 1, before
  the directions are summed;
- ``quad_pergroup.y``: ``QuadGroupSS2D``'s scan + group-LN output, on the
  bf16/fp32 route and the int8 one;
- ``quad_sandwich.out``: in the JAX package, the out-projection's output of
  its batch-last layout (batch >= 64); that layout does not carry over, so
  the port checks the same tensor, ``QuadGroupSS2D``'s output, at every
  batch.

A check reads two flags back from the device (one host sync per guard).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def check_nan_inf(tag: str, x: torch.Tensor) -> torch.Tensor:
    """``x``; raises ``FloatingPointError`` naming ``tag`` when ``x`` holds
    a nan or an inf."""
    xf = x.detach().float()
    has_nan, has_inf = bool(torch.isnan(xf).any()), bool(
        torch.isinf(xf).any())
    if has_nan or has_inf:
        raise FloatingPointError(
            f"check_nan_inf[{tag}]: nan={has_nan} inf={has_inf}")
    return x


@dataclasses.dataclass
class DebugGuards:
    """The guards a model runs: ``nancheck`` raises on a nan or inf at each
    guard; ``capturing`` keeps host copies of the tagged tensors in
    :attr:`captured` (``"<tag>.<name>"``), the latest call's."""
    nancheck: bool = False
    capturing: bool = False
    captured: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def check_nan_inf(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        return check_nan_inf(tag, x) if self.nancheck else x

    def capture(self, tag: str, **tensors: torch.Tensor) -> None:
        if self.capturing:
            for k, v in tensors.items():
                self.captured[f"{tag}.{k}"] = v.detach().cpu()


def attach(model: torch.nn.Module, guards) -> torch.nn.Module:
    """Give every module of ``model`` that runs guards (those with a
    ``debug`` attribute) ``guards`` (a :class:`DebugGuards`, or None for
    none); returns the model."""
    for m in model.modules():
        if hasattr(m, "debug"):
            m.debug = guards
    return model
