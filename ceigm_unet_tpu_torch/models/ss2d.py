"""2-D selective-scan modules, channel-last.

:class:`QuadGroupSS2D`: four channel groups, each selective-scanned in its
own direction, through one fused scan + group-LN op. Counterpart of
``ceigm_unet_tpu/models/ss2d.py`` ``QuadGroupSS2D`` in the NHWC form of its
``_quad_pergroup(cat=True)`` path. The parameters keep the reference layout
of four per-group SS2D modules ``mamba_g1..g4`` (``convert/torch_import.py``
``_quad_ss2d`` stacks them for JAX); the forward runs the K-grouped
projections as block-diagonal GEMMs and hands the (B, L, K, D) GEMM outputs
to :func:`quad_scan_ln_cat` as strided views. Two build arguments select the
JAX package's switched TPU kernels: ``dwconv="kernel"`` (``CEIGM_BLDW``) runs
the depthwise conv as :func:`dwconv3x3` on the in-projection output in
place, and ``quant_scan=True`` (``CEIGM_QUANT=1``) stores u and dt as int8
for :func:`quad_scan_ln_cat_q8` (inference only).

:class:`SS2D`: the VMamba flavour, K directions over all channels (the
legacy MSVM-UNet's encoder and decoder op).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ceigm_unet_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear,
                                                dw_conv)
from ceigm_unet_tpu_torch.ops.cross_scan import cross_merge_1d, cross_scan_1d
from ceigm_unet_tpu_torch.ops.dwconv import dwconv3x3
from ceigm_unet_tpu_torch.ops.quad_scan import (quad_scan_ln_cat,
                                                quad_scan_ln_cat_q8, sscan_dir)
from ceigm_unet_tpu_torch.ops.selective_scan import selective_scan
from ceigm_unet_tpu_torch.parallel import sp_context
from ceigm_unet_tpu_torch.parallel.sp_ss2d import (quad_group_ss2d_sp,
                                                   quad_group_ss2d_stacked,
                                                   ss2d_scan)
from ceigm_unet_tpu_torch.utils.spans import span


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


def q8(t: torch.Tensor):
    """int8 storage of a (B, L, K, D) activation, as the JAX package's
    ``q8``: per-(K, D) amax over B and L in fp32, scale max(amax, 1e-6) /
    127, round half to even, clamp to +-127. Returns (int8 values, (K, D)
    fp32 scales). The scales depend on the whole batch."""
    tf = t.float()
    scale = tf.abs().amax(dim=(0, 1)).clamp_min(1e-6) / 127.0
    return torch.round(tf / scale).clamp(-127, 127).to(torch.int8), scale


class QuadGroupSS2D(nn.Module):
    """(B, H, W, C) -> (B, H, W, C); group k of C/4 channels is scanned in
    direction ``DIRECTIONS[k]``.

    ``dwconv``: ``"library"`` runs the depthwise conv as ``F.conv2d``;
    ``"kernel"`` as :func:`dwconv3x3` (``csrc/dwconv3.cu`` on the card), the
    counterpart of ``CEIGM_BLDW`` other than ``xla``, at every batch (the
    JAX switch acts only inside its batch >= 64 sandwich).
    ``quant_scan``: the counterpart of ``CEIGM_QUANT=1``: xc and dt are
    stored as int8 (:func:`q8`) and scanned by :func:`quad_scan_ln_cat_q8`,
    whose bf16 output is cast to the compute dtype before the z-gate. It
    applies at every batch (the JAX gate takes it only below batch 64 or
    with ``CEIGM_BLAST`` <= 1) and is inference-only: a forward with inputs
    that require grad raises.

    ``debug``: the model's ``utils.debug.DebugGuards`` (None: no guard), at
    ``quad_pergroup.y`` and ``quad_sandwich.out``.

    Under ``parallel.sp_context.sp_scan_island``, :meth:`scan_groups` (the
    forward, and the scan of ``GroupMambaLayer``'s forward) takes x as this
    rank's H-shard (B, H/n, W, C) and runs
    ``parallel.sp_ss2d.quad_group_ss2d_sp`` over the island's group; under
    ``sp_stacked(n)`` x is n shards stacked in the batch, (n*B, H/n, W, C),
    and it runs ``quad_group_ss2d_stacked`` (no debug guard there;
    ``quant_scan`` raises)."""

    DIRECTIONS = (1, 2, 3, 4)
    debug = None

    def __init__(self, dim: int, quant_scan: bool = False,
                 dwconv: str = "library"):
        super().__init__()
        if dwconv not in ("library", "kernel"):
            raise ValueError(f"QuadGroupSS2D: dwconv {dwconv!r}, expected "
                             f"'library' or 'kernel'")
        self.quant_scan, self.dwconv = quant_scan, dwconv
        for k in range(len(self.DIRECTIONS)):
            self.add_module(f"mamba_g{k + 1}",
                            SS2DGroup(dim // len(self.DIRECTIONS)))

    def groups(self):
        return [getattr(self, f"mamba_g{k + 1}")
                for k in range(len(self.DIRECTIONS))]

    def fused_weights(self, dt: torch.dtype):
        """The tensors the forward derives from the weights alone: the
        block-diagonal projections in ``dt``, the depthwise conv in ``dt``
        (fp32 for the kernel, which takes fp32 taps as the TPU kernel does),
        and the scan's (K, D) parameters (A, dt bias, D, LN scale, LN bias)
        in fp32. Inside the span ``derive.ss2d``."""
        with span("derive.ss2d"):
            gs = self.groups()
            D = gs[0].d_inner
            bd = lambda ws: torch.block_diag(*ws).to(dt)
            w_in = [g.in_proj.weight for g in gs]              # (2D, dg)
            w_xz = torch.cat([bd([w[:D].t() for w in w_in]),
                              bd([w[D:].t() for w in w_in])], dim=1)
            stack = lambda ps: torch.stack(
                [p.reshape(D) for p in ps]).float()
            conv_dt = torch.float32 if self.dwconv == "kernel" else dt
            return dict(
                w_xz=w_xz,
                conv_w=torch.cat([g.conv2d.weight for g in gs]).to(
                    conv_dt),
                conv_b=torch.cat([g.conv2d.bias for g in gs]).to(conv_dt),
                w_x=bd([g.x_proj_weight[0].t() for g in gs]),
                w_dt=bd([g.dt_projs_weight[0].t() for g in gs]),
                w_out=bd([g.out_proj.weight.t() for g in gs]),
                scan=(-torch.exp(stack([g.A_logs for g in gs])),
                      stack([g.dt_projs_bias for g in gs]),
                      stack([g.Ds for g in gs]),
                      stack([g.out_norm.weight for g in gs]),
                      stack([g.out_norm.bias for g in gs])))

    def scan_groups(self, x: torch.Tensor) -> torch.Tensor:
        ring = sp_context.ring()
        if ring is not None:
            # x is this rank's H-shard, or the shards stacked in the batch
            # (parallel/sp_context.py); routed here, where GroupMambaLayer's
            # forward enters the block too
            if sp_context.active() is not None:
                return quad_group_ss2d_sp(self, x, ring.group)
            return ring.unlead(quad_group_ss2d_stacked(self, ring.lead(x)))
        B, H, W, C = x.shape
        L = H * W
        gs = self.groups()
        K, D, R = len(gs), gs[0].d_inner, gs[0].dt_rank
        Din = K * D
        fw = self.fused_weights(x.dtype)
        xz = x.reshape(B * L, C) @ fw["w_xz"]                  # (BL, 2Din)
        z = F.silu(xz[:, Din:])
        if self.dwconv == "kernel":
            # the channel slice of xz read in place (row stride 2*Din)
            xc = F.silu(dwconv3x3(xz[:, :Din].view(B, H, W, Din),
                                  fw["conv_w"], fw["conv_b"]))
        else:
            xc = F.conv2d(xz[:, :Din].reshape(B, H, W, Din).permute(
                0, 3, 1, 2), fw["conv_w"], fw["conv_b"], padding=1,
                groups=Din)
            xc = F.silu(xc).permute(0, 2, 3, 1)
        xc = xc.reshape(B * L, Din)
        x_dbl = (xc @ fw["w_x"]).view(B, L, K, R + 2)
        dts = x_dbl[..., :R].reshape(B * L, K * R)
        dtv = (dts @ fw["w_dt"]).view(B, L, K, D)
        BC = (x_dbl[..., R].permute(0, 2, 1),
              x_dbl[..., R + 1].permute(0, 2, 1))              # (B, K, L)
        if self.quant_scan:
            (uq, su), (dq, sdt) = q8(xc.view(B, L, K, D)), q8(dtv)
            y = quad_scan_ln_cat_q8(
                uq.permute(0, 2, 1, 3), dq.permute(0, 2, 1, 3), su, sdt, *BC,
                *fw["scan"], H, W, self.DIRECTIONS).to(x.dtype)
        else:
            y = quad_scan_ln_cat(
                xc.view(B, L, K, D).permute(0, 2, 1, 3),
                dtv.permute(0, 2, 1, 3), *BC, *fw["scan"], H, W,
                self.DIRECTIONS)                               # (B, L, Din)
        if self.debug is not None:
            y = self.debug.check_nan_inf("quad_pergroup.y", y)
        out = ((y.view(B * L, Din) * z) @ fw["w_out"]).view(B, H, W, C)
        if self.debug is not None:
            out = self.debug.check_nan_inf("quad_sandwich.out", out)
        return out

    def forward(self, x):
        return self.scan_groups(x)


def init_ssm_params(m: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of an SSM parameter bundle (``x_proj_weight``,
    ``dt_projs_weight``, ``dt_projs_bias``, ``A_logs``, ``Ds``; ``d_inner``
    D and ``dt_rank`` R) after the JAX package's ``_SSMParams``:
    U(+-D^-1/2), U(+-R^-1/2), the softplus-inverse of a log-uniform dt in
    [1e-3, 0.1], log(1..N), ones."""
    D, R, g = m.d_inner, m.dt_rank, generator
    nn.init.uniform_(m.x_proj_weight, -D ** -0.5, D ** -0.5, generator=g)
    nn.init.uniform_(m.dt_projs_weight, -R ** -0.5, R ** -0.5, generator=g)
    r = torch.rand(m.dt_projs_bias.shape, generator=g)
    dt = torch.exp(r * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3)).clamp_min(1e-4)
    with torch.no_grad():
        m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        n = m.A_logs.shape[-1]
        m.A_logs.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32)).expand_as(m.A_logs))
        m.Ds.fill_(1.0)


def ssm_scan_core(xs, x_proj_w, dt_w, dt_b, A_logs, Ds, d_state: int,
                  dt_rank: int, debug=None) -> torch.Tensor:
    """(B, K, D, L) post-conv activations -> ys (B, K, D, L) fp32: the
    projections, then ONE ``selective_scan`` with the K directions folded
    into its channel axis and B/C grouped per direction (the JAX package's
    ``ssm_scan_core``). ``debug`` (a ``DebugGuards``, or None) checks ys at
    ``ssm_scan_core.ys`` and captures us/dts/Bs/Cs/ys as ``ssm_scan_core``."""
    B, K, D, L = xs.shape
    x_dbl = torch.einsum("bkdl,kcd->bkcl", xs, x_proj_w.to(xs.dtype))
    dts, Bs, Cs = torch.split(x_dbl, [dt_rank, d_state, d_state], dim=2)
    dts = torch.einsum("bkrl,kdr->bkdl", dts, dt_w.to(xs.dtype))
    ys = selective_scan(xs.reshape(B, K * D, L), dts.reshape(B, K * D, L),
                        -torch.exp(A_logs.float()), Bs, Cs, Ds,
                        dt_b.reshape(-1), delta_softplus=True,
                        out_dtype=torch.float32)
    if debug is not None:
        ys = debug.check_nan_inf("ssm_scan_core.ys", ys)
        debug.capture("ssm_scan_core", us=xs, dts=dts, Bs=Bs, Cs=Cs, ys=ys)
    return ys.reshape(B, K, D, L)


class SS2D(nn.Module):
    """VMamba-flavour SS2D: K directions over all ``d_inner`` channels.

    Counterpart of ``ceigm_unet_tpu/models/ss2d.py`` ``SS2D``, forward types
    ``v2`` (z-gate silu(z)) and ``v05_noz`` (none). Reference keys:
    ``in_proj``, ``conv2d``, ``x_proj_weight`` (K, R+2N, D),
    ``dt_projs_weight`` (K, D, R), ``dt_projs_bias`` (K, D), ``A_logs``
    (K*D, N), ``Ds`` (K*D,), ``out_norm``, ``out_proj``.

    ``d_state`` 1 takes the JAX package's TPU default route
    (``quad_ssm_nhwc``): x_dbl is one GEMM of xc against all K directions'
    ``x_proj_weight``, dt a per-direction GEMM, and :func:`sscan_dir` (K10)
    scans a stride-0 view of xc in each direction; the directions are summed.
    Any other ``d_state`` takes cross_scan -> :func:`ssm_scan_core`
    (``selective_scan``) -> cross_merge. The direction sum is followed by
    ``out_norm`` (fp32) and ``out_proj``.

    ``debug``: the model's ``utils.debug.DebugGuards`` (None: no guard), at
    ``quad_ssm_nhwc.y`` (d_state 1) or in :func:`ssm_scan_core`.

    Under ``parallel.sp_context``'s context x is H-shards (this rank's, or
    n stacked in the batch): the conv takes its row halo and the four
    directions scan on the context's ring
    (``parallel.sp_ss2d.ss2d_scan``, K11; no debug guard there).
    """

    DIRECTIONS = (1, 2, 3, 4)
    debug = None

    def __init__(self, d_model: int, d_state: int = 1,
                 ssm_ratio: float = 1.0, dt_rank="auto", d_conv: int = 3,
                 conv_bias: bool = True, bias: bool = False,
                 forward_type: str = "v2"):
        super().__init__()
        if forward_type not in ("v2", "v05_noz"):
            raise ValueError(f"SS2D: forward_type {forward_type!r}")
        D = int(ssm_ratio * d_model)
        R = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        K, N = len(self.DIRECTIONS), d_state
        self.d_inner, self.dt_rank, self.d_state = D, R, N
        self.disable_z = forward_type.endswith("_noz")
        self.in_proj = Linear(d_model, D if self.disable_z else 2 * D,
                              bias=bias)
        self.conv2d = dw_conv(D, d_conv, conv_bias) if d_conv > 1 else None
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.zeros(K * D, N))
        self.Ds = nn.Parameter(torch.ones(K * D))
        self.out_norm = LayerNorm(D)
        self.out_proj = Linear(D, d_model, bias=bias)

    def _scan_directions(self, xc: torch.Tensor) -> torch.Tensor:
        """d_state 1: (B, H, W, D) -> the direction sum (B, H, W, D) fp32."""
        B, H, W, D = xc.shape
        L, K, R = H * W, len(self.DIRECTIONS), self.dt_rank
        xf = xc.reshape(B * L, D)
        w_x = self.x_proj_weight.reshape(K * (R + 2), D).t().to(xc.dtype)
        x_dbl = (xf @ w_x).view(B, L, K, R + 2)
        dts = x_dbl[..., :R].permute(2, 0, 1, 3).reshape(K, B * L, R)
        dt = torch.bmm(dts, self.dt_projs_weight.transpose(1, 2).to(
            xc.dtype))                                         # (K, BL, D)
        y = sscan_dir(
            xf.view(B, 1, L, D).expand(B, K, L, D),
            dt.view(K, B, L, D).permute(1, 0, 2, 3),
            x_dbl[..., R].permute(0, 2, 1), x_dbl[..., R + 1].permute(0, 2, 1),
            -torch.exp(self.A_logs.float()).reshape(K, D),
            self.dt_projs_bias.float(), self.Ds.float().reshape(K, D), H, W,
            self.DIRECTIONS)                                   # (B, K, L, D)
        if self.debug is not None:
            y = self.debug.check_nan_inf("quad_ssm_nhwc.y", y)
        return y.sum(1).view(B, H, W, D)

    def _scan_cross(self, xc: torch.Tensor) -> torch.Tensor:
        """Any d_state: cross_scan -> selective_scan -> cross_merge."""
        B, H, W, D = xc.shape
        xs = torch.stack([cross_scan_1d(xc, k) for k in self.DIRECTIONS],
                         dim=1)                                # (B, K, D, L)
        ys = ssm_scan_core(xs, self.x_proj_weight, self.dt_projs_weight,
                           self.dt_projs_bias, self.A_logs, self.Ds,
                           self.d_state, self.dt_rank, self.debug)
        return sum(cross_merge_1d(ys[:, i], k, H, W)
                   for i, k in enumerate(self.DIRECTIONS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xz = self.in_proj(x)
        z = None
        if self.disable_z:
            xc = xz
        else:
            xc, z = xz.chunk(2, dim=-1)
            z = F.silu(z)
        if self.conv2d is not None:
            xc = self.conv2d(xc)            # a row halo under the context
        xc = F.silu(xc)
        ring = sp_context.ring()
        if ring is not None:
            y = ss2d_scan(self, xc, ring)
        elif self.d_state == 1:
            y = self._scan_directions(xc)
        else:
            y = self._scan_cross(xc)
        y = self.out_norm(y).to(x.dtype)
        if z is not None:
            y = y * z
        return self.out_proj(y)
