"""Eval-mode LGAG attention gate, fused: x * psi.

Counterpart of ``ceigm_unet_tpu/ops/tapconv.py`` ``lgag_gate_eval``, with the
same arguments. The host-side fold is the same: the six grouped 2-in/1-out
convs (both branches read g) become one 5x5x2xC2 tap stack, and the shared
BatchNorm and the psi BatchNorm become per-channel (a1, b1) and scalar
(a2, c2) affines. :func:`lgag_gate` then launches ``csrc/lgag.cu`` for CUDA
tensors and runs :func:`lgag_gate_ref` for CPU tensors. Training does not
take this path (LGAG runs its unfolded form there, with batch statistics);
the op's backward, for completeness, is the vector-Jacobian product of the
plain version.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops import _build
from ceigm_unet_tpu_torch.ops.recompute import recompute_vjp

BN_EPS = 1e-5


def lgag_fold(convs: List[Tuple[torch.Tensor, torch.Tensor]],
              bn: Dict[str, torch.Tensor], psi_w: torch.Tensor,
              psi_b: torch.Tensor, psi_bn: Dict[str, torch.Tensor]):
    """-> (taps (5, 5, 2, C2), a1 (C2,), b1 (C2,), psi_w (C2,),
    scalars (3,) = [psi_b, a2, c2]), all fp32."""
    f = lambda t: t.float()
    C2 = convs[0][0].shape[-1]
    taps = torch.zeros((5, 5, 2, C2), dtype=torch.float32,
                       device=convs[0][0].device)
    for kern, _ in convs:
        o = (5 - kern.shape[0]) // 2
        taps[o:5 - o, o:5 - o] += f(kern)
    bias_total = sum(f(b) for _, b in convs)
    a1 = f(bn["scale"]) * torch.rsqrt(f(bn["var"]) + BN_EPS)
    # bn(Sg) + bn(Sx) = a1*(Sg + Sx) + a1*bias_total + 2*(bias - a1*mean):
    # the shared BN's shift is counted once per branch
    b1 = a1 * bias_total + 2.0 * (f(bn["bias"]) - a1 * f(bn["mean"]))
    a2 = f(psi_bn["scale"][0]) * torch.rsqrt(f(psi_bn["var"][0]) + BN_EPS)
    c2 = f(psi_bn["bias"][0]) - a2 * f(psi_bn["mean"][0])
    scalars = torch.stack([f(psi_b.reshape(())), a2, c2])
    return taps, a1, b1, f(psi_w.reshape(-1)), scalars


def lgag_gate_ref(g, x, taps, a1, b1, psi_w, scalars):
    """Plain PyTorch version of :func:`lgag_gate` (fp32 arithmetic)."""
    C2 = taps.shape[-1]
    w = taps.permute(3, 2, 0, 1)                          # (C2, 2, 5, 5)
    acc = F.conv2d(g.float().permute(0, 3, 1, 2), w, padding=2, groups=C2)
    r = torch.relu(acc.permute(0, 2, 3, 1) * a1 + b1)
    p = (r * psi_w).sum(-1, keepdim=True)
    psi = torch.sigmoid(scalars[1] * (p + scalars[0]) + scalars[2])
    return (x.float() * psi).to(x.dtype)


def _lgag_launch(g, x, taps, a1, b1, psi_w, scalars):
    B, H, W, C = g.shape
    if g.device.type != "cuda":
        raise ValueError(f"lgag_gate: no kernel for {g.device}")
    # the kernel moves 4-byte words or wider: a bf16 view one element into
    # its storage is copied to an aligned buffer
    gc, xc = [t.contiguous() if t.data_ptr() % 4 == 0
              else t.clone(memory_format=torch.contiguous_format)
              for t in (g, x)]
    prm = [t.to(device=g.device, dtype=torch.float32).contiguous()
           for t in (taps, a1, b1, psi_w, scalars)]
    _build.check_cuda(gc, xc, *prm)
    out = torch.empty_like(xc)
    p = _build.ptr
    _build.launch("lgag_gate", p(gc), p(xc), *[p(t) for t in prm], p(out),
                  B, H, W, C, _build.dtype_code(x))
    return out


class LgagGate(torch.autograd.Function):
    """Autograd op of :func:`lgag_gate`."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if args[0].device.type == "cpu":
            return lgag_gate_ref(*args)
        return _lgag_launch(*args)

    @staticmethod
    def backward(ctx, go):
        return recompute_vjp(lgag_gate_ref, ctx.saved_tensors,
                             ctx.needs_input_grad, go)


def lgag_gate(g, x, taps, a1, b1, psi_w, scalars):
    """g, x (B, H, W, C) with C = 2*C2; folded parameters from
    :func:`lgag_fold`. Returns x * psi in x's dtype."""
    B, H, W, C = g.shape
    C2 = C // 2
    if x.shape != g.shape or C != 2 * C2 or tuple(taps.shape) != (5, 5, 2, C2):
        raise ValueError(f"lgag_gate: g {tuple(g.shape)} x {tuple(x.shape)} "
                         f"taps {tuple(taps.shape)}")
    if g.dtype != x.dtype:
        raise TypeError("lgag_gate: g and x must share a dtype")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lgag_gate: no kernel for {g.device}")
    return LgagGate.apply(g, x, taps, a1, b1, psi_w, scalars)


def lgag_gate_eval(g, x, convs, bn, psi_w, psi_b, psi_bn):
    """Fused eval-mode LGAG gate. convs: [(kernel (k, k, 2, C2), bias)] for
    W_g_1, W_g_3, W_g_5, W_x_1, W_x_3, W_x_5 in flax layout; bn / psi_bn:
    dicts with scale, bias, mean, var; psi_w (1, 1, C2, 1). Returns
    x * sigmoid(psi_bn(conv1x1(relu(bn(...))))) in x's dtype."""
    return lgag_gate(g, x, *lgag_fold(convs, bn, psi_w, psi_b, psi_bn))
