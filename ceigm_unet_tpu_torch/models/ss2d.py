"""QuadGroupSS2D: four channel groups, each selective-scanned in its own
direction, through one fused scan + group-LN op.

Counterpart of ``ceigm_unet_tpu/models/ss2d.py`` ``QuadGroupSS2D`` in the
NHWC form of its ``_quad_pergroup(cat=True)`` path. The parameters keep the
reference layout of four per-group SS2D modules ``mamba_g1..g4``
(``convert/torch_import.py`` ``_quad_ss2d`` stacks them for JAX); the
forward runs the K-grouped projections as block-diagonal GEMMs and hands
the (B, L, K, D) GEMM outputs to :func:`quad_scan_ln_cat` as strided views.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ceigm_unet_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from ceigm_unet_tpu_torch.ops.quad_scan import quad_scan_ln_cat


class SS2DGroup(nn.Module):
    """One group's parameters (reference per-group SS2D with the live
    settings: d_state 1, ssm_ratio 1, d_conv 3)."""

    def __init__(self, d_model: int):
        super().__init__()
        D = d_model
        R = math.ceil(d_model / 16)
        self.d_inner, self.dt_rank = D, R
        self.in_proj = Linear(d_model, 2 * D, bias=False)
        self.conv2d = Conv2d(D, D, 3, padding=1, groups=D)
        self.x_proj_weight = nn.Parameter(torch.empty(1, R + 2, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(1, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(1, D))
        self.A_logs = nn.Parameter(torch.zeros(D, 1))
        self.Ds = nn.Parameter(torch.ones(D))
        self.out_norm = LayerNorm(D)
        self.out_proj = Linear(D, d_model, bias=False)


class QuadGroupSS2D(nn.Module):
    """(B, H, W, C) -> (B, H, W, C); group k of C/4 channels is scanned in
    direction ``DIRECTIONS[k]``."""

    DIRECTIONS = (1, 2, 3, 4)

    def __init__(self, dim: int):
        super().__init__()
        for k in range(len(self.DIRECTIONS)):
            self.add_module(f"mamba_g{k + 1}",
                            SS2DGroup(dim // len(self.DIRECTIONS)))

    def groups(self):
        return [getattr(self, f"mamba_g{k + 1}")
                for k in range(len(self.DIRECTIONS))]

    def fused_weights(self, dt: torch.dtype):
        """The tensors the forward derives from the weights alone: the
        block-diagonal projections and the depthwise conv in ``dt``, and the
        scan's (K, D) parameters (A, dt bias, D, LN scale, LN bias) in fp32.
        """
        gs = self.groups()
        D = gs[0].d_inner
        bd = lambda ws: torch.block_diag(*ws).to(dt)
        w_in = [g.in_proj.weight for g in gs]                  # (2D, dg)
        w_xz = torch.cat([bd([w[:D].t() for w in w_in]),
                          bd([w[D:].t() for w in w_in])], dim=1)
        stack = lambda ps: torch.stack([p.reshape(D) for p in ps]).float()
        return dict(
            w_xz=w_xz,
            conv_w=torch.cat([g.conv2d.weight for g in gs]).to(dt),
            conv_b=torch.cat([g.conv2d.bias for g in gs]).to(dt),
            w_x=bd([g.x_proj_weight[0].t() for g in gs]),
            w_dt=bd([g.dt_projs_weight[0].t() for g in gs]),
            w_out=bd([g.out_proj.weight.t() for g in gs]),
            scan=(-torch.exp(stack([g.A_logs for g in gs])),
                  stack([g.dt_projs_bias for g in gs]),
                  stack([g.Ds for g in gs]),
                  stack([g.out_norm.weight for g in gs]),
                  stack([g.out_norm.bias for g in gs])))

    def scan_groups(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        L = H * W
        gs = self.groups()
        K, D, R = len(gs), gs[0].d_inner, gs[0].dt_rank
        Din = K * D
        fw = self.fused_weights(x.dtype)
        xz = x.reshape(B * L, C) @ fw["w_xz"]                  # (BL, 2Din)
        z = F.silu(xz[:, Din:])
        xc = F.conv2d(xz[:, :Din].reshape(B, H, W, Din).permute(0, 3, 1, 2),
                      fw["conv_w"], fw["conv_b"], padding=1, groups=Din)
        xc = F.silu(xc).permute(0, 2, 3, 1).reshape(B * L, Din)
        x_dbl = (xc @ fw["w_x"]).view(B, L, K, R + 2)
        dts = x_dbl[..., :R].reshape(B * L, K * R)
        dtv = (dts @ fw["w_dt"]).view(B, L, K, D)
        y = quad_scan_ln_cat(
            xc.view(B, L, K, D).permute(0, 2, 1, 3), dtv.permute(0, 2, 1, 3),
            x_dbl[..., R].permute(0, 2, 1), x_dbl[..., R + 1].permute(0, 2, 1),
            *fw["scan"], H, W, self.DIRECTIONS)                # (B, L, Din)
        out = (y.view(B * L, Din) * z) @ fw["w_out"]
        return out.view(B, H, W, C)

    def forward(self, x):
        return self.scan_groups(x)
