"""H-sharded QuadGroupSS2D and SS2D: each block's forward, differentiable,
on a 2-D feature map whose H axis is cut into n shards.

Counterpart of ``ceigm_unet_tpu/parallel/sp_ss2d.py``, the scan island
that the JAX package runs under ``shard_map``. Per scan direction (the
reference CrossScan_1..4):

- directions 1 and 3 (row-major): H-sharding is a contiguous cut of the
  row-major order, so the ring scan (``parallel/ring_scan.py``) runs on
  the shard as it is (``reverse`` for 3);
- directions 2 and 4 (column-major): one all-to-all re-shards the
  direction's scan inputs from H to W, where the column-major order
  (step w*H + h) is a contiguous cut again; the scan runs there and one
  all-to-all brings its output back;
- the depthwise 3x3 conv takes a one-row halo from each neighbouring
  shard; the shards at the image's edges receive zeros, the global 'SAME'
  padding.

The shards live on the ranks of a ``torch.distributed`` group
(:func:`quad_group_ss2d_sp`, this rank's (B, H/n, W, C)) or stacked on a
leading axis of one tensor in one process (:func:`quad_group_ss2d_stacked`,
(n, B, H/n, W, C)); one body of code runs both, over ``ring_scan``'s
``_GroupRing`` or ``_StackedRing``. Every local scan is K11
(``scan_rows``): two per direction in the forward, two more in the
backward. No exchange gathers H or L: the ring's all-gathers carry one
(decay, state) pair per scanned row and shard.

The legacy MSVM-UNet's SS2D (``models/ss2d.py``: K directions over all
channels) scans the same four directions on the same ring
(:func:`ss2d_scan`): each direction's projections are pointwise, so the
post-conv map is re-sharded from H to W once, and the column-major
directions' projections and scans run there; their summed output comes
back in one more all-to-all. Every local scan is K11 here too (two per
direction in the forward); the unsharded SS2D's K10 (``sscan_dir``)
returns no final state, which the ring carries. The JAX package leaves
this op to GSPMD's own partitioning; here no exchange gathers L.

Parameter gradients: each rank's backward holds its shard's share of a
parameter's gradient; the gradient of a loss summed over the whole image
is the sum of the shares over the group (what ``shard_map`` computes for
replicated parameters), not their mean.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops.dwconv import dwconv3x3
from ceigm_unet_tpu_torch.ops.quad_scan import LN_EPS
from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.parallel.ring_scan import (_GroupRing,
                                                     _StackedRing,
                                                     selective_scan_ring)
from ceigm_unet_tpu_torch.parallel.sp_context import sp_scan_island, sp_stacked
from ceigm_unet_tpu_torch.parallel.sp_ops import row_halo


class _AllToAll(torch.autograd.Function):
    """The ring's all-to-all; it is its own adjoint (row j to shard j and
    row i from shard i is a transpose of the shard blocks)."""

    @staticmethod
    def forward(ctx, t, ring):
        ctx.ring = ring
        return ring.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_to_all(g), None


def _transpose_shards(q, ring):
    """(*lead, B, S/n, T, d) cut along S -> (*lead, B, T/n, S, d) cut along
    T: the image transposed, re-sharded by one all-to-all. From H-shards
    it gives W-shards of the transposed image, whose row-major order is
    the column-major walk; applied again it brings them back."""
    t = q.unflatten(-2, (ring.n, q.shape[-2] // ring.n)).movedim(-3, 0)
    s = _AllToAll.apply(t, ring)         # (n_from, *lead, B, S/n, T/n, d)
    return s.movedim(0, -4).movedim(-2, -4).flatten(-3, -2)


def _island(block, x, ring):
    """The block's forward on shards: x (*lead, B, H/n, W, C)."""
    if block.quant_scan:
        raise ValueError("quad_group_ss2d_sp: the int8 scan (quant_scan="
                         "True) has no sharded form")
    *lead, B, Hl, W, C = x.shape
    if W % ring.n:
        raise ValueError(f"quad_group_ss2d_sp: {ring.n} shards do not divide "
                         f"W {W} (the column-major directions re-shard W)")
    gs = block.groups()
    K, D, R = len(gs), gs[0].d_inner, gs[0].dt_rank
    Din = K * D
    fw = block.fused_weights(x.dtype)
    xz = x.reshape(-1, C) @ fw["w_xz"]                     # (M, 2Din)
    z = F.silu(xz[:, Din:])
    xh = row_halo(xz[:, :Din].view(*lead, B, Hl, W, Din), ring, 1, 1)
    xh = xh.reshape(-1, Hl + 2, W, Din)
    if block.dwconv == "kernel":
        xc = dwconv3x3(xh, fw["conv_w"], fw["conv_b"])[:, 1:-1]
    else:
        xc = F.conv2d(xh.permute(0, 3, 1, 2), fw["conv_w"], fw["conv_b"],
                      padding=(0, 1), groups=Din).permute(0, 2, 3, 1)
    xc = F.silu(xc).reshape(-1, Din)
    x_dbl = (xc @ fw["w_x"]).view(-1, K, R + 2)
    dt = (x_dbl[..., :R].reshape(-1, K * R) @ fw["w_dt"]).view(-1, K, D)
    A, bias, Ds, ln_scale, ln_bias = fw["scan"]
    ys = []
    for i, dirn in enumerate(block.DIRECTIONS):
        # the direction's scan inputs, (*lead, B, Hl, W, D + D + 1 + 1)
        q = torch.cat([xc.view(-1, K, D)[:, i], dt[:, i],
                       x_dbl[:, i, R:]], -1).view(*lead, B, Hl, W, -1)
        cm = dirn in (2, 4)
        if cm:
            q = _transpose_shards(q, ring)
        sh = q.shape[:-1]                                 # (.., S1, S2)
        q = q.flatten(-3, -2).transpose(-1, -2)           # (.., 2D+2, L)
        u, dti, Bi, Ci = q.split([D, D, 1, 1], dim=-2)
        y = selective_scan_ring(u, dti, A[i][:, None], Bi.unsqueeze(-3),
                                Ci.unsqueeze(-3), Ds[i], bias[i], True, ring,
                                reverse=dirn in (3, 4))
        y = y.transpose(-1, -2).reshape(*sh, D)
        ys.append(_transpose_shards(y, ring) if cm else y)
    yg = F.layer_norm(torch.stack(ys, -2), (D,), eps=LN_EPS) * ln_scale \
        + ln_bias                                         # fp32
    out = (yg.to(x.dtype).reshape(-1, Din) * z) @ fw["w_out"]
    return out.view(*lead, B, Hl, W, C)


def quad_group_ss2d_sp(block, x: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None):
    """``block`` (a ``models.ss2d.QuadGroupSS2D``) on this rank's H-shard
    x (B, H/n, W, C) of an image sharded in rank order over ``group`` (the
    active group by default): returns this rank's shard of the block's
    output. Every rank of the group calls it, and its backward, together.
    Raises without a group, with ``quant_scan``, or when n does not divide
    W."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("quad_group_ss2d_sp: no process group (see "
                           "parallel.init_data_parallel)")
    return _island(block, x, _GroupRing(group))


def quad_group_ss2d_stacked(block, x: torch.Tensor) -> torch.Tensor:
    """:func:`quad_group_ss2d_sp`'s arithmetic on n H-shards stacked on
    the leading axis of x (n, B, H/n, W, C) in one process: returns the
    (n, B, H/n, W, C) shards of the block's output."""
    return _island(block, x, _StackedRing(x.shape[0]))


def ss2d_scan(op, xc: torch.Tensor, ring) -> torch.Tensor:
    """The scans of ``op`` (a ``models.ss2d.SS2D``, any ``d_state``) on the
    H-shards of its post-conv map xc (model layout (Bt, H/n, W, D)) over
    ``ring``: returns the shards of the four directions' sum, fp32.

    Direction k scans with ``x_proj_weight[k]`` (dt, B, C rows),
    ``dt_projs_weight[k]`` / ``dt_projs_bias[k]`` and the rows [k*D,
    (k+1)*D) of ``A_logs`` and ``Ds``, as the unsharded op's
    ``_scan_directions`` and ``_scan_cross`` do."""
    xl = ring.lead(xc)                                # (*lead, B, Hl, W, D)
    W, D = xl.shape[-2:]
    if W % ring.n:
        raise ValueError(f"sharded SS2D: {ring.n} shards do not divide W "
                         f"{W} (the column-major directions re-shard W)")
    R, N, K = op.dt_rank, op.d_state, len(op.DIRECTIONS)
    A = -torch.exp(op.A_logs.float()).view(K, D, N)
    Ds = op.Ds.float().view(K, D)
    # the map re-sharded once: W-shards of the transposed image, whose
    # row-major order is the column-major walk
    maps = {False: xl, True: _transpose_shards(xl, ring)}
    sums = {}
    for k, dirn in enumerate(op.DIRECTIONS):
        cm = dirn in (2, 4)
        u = maps[cm].flatten(-3, -2)                  # (.., B, L/n, D)
        x_dbl = u @ op.x_proj_weight[k].t().to(u.dtype)
        dt = x_dbl[..., :R] @ op.dt_projs_weight[k].t().to(u.dtype)
        B4, C4 = x_dbl[..., R:].transpose(-1, -2).unflatten(
            -2, (2, 1, N)).unbind(-4)                 # (.., B, 1, N, L/n)
        y = selective_scan_ring(u.transpose(-1, -2), dt.transpose(-1, -2),
                                A[k], B4, C4, Ds[k], op.dt_projs_bias[k],
                                True, ring, reverse=dirn in (3, 4))
        y = y.transpose(-1, -2).reshape(maps[cm].shape)
        sums[cm] = y if cm not in sums else sums[cm] + y
    return ring.unlead(sums[False] + _transpose_shards(sums[True], ring))


def ss2d_sp(op, x: torch.Tensor,
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``op`` (a ``models.ss2d.SS2D``) on this rank's H-shard x (B, H/n, W,
    C) of an image sharded in rank order over ``group`` (the active group
    by default): returns this rank's shard of the op's output. Every rank
    of the group calls it, and its backward, together. Raises without a
    group, or when n does not divide W."""
    with sp_scan_island(group):
        return op(x)


def ss2d_stacked(op, x: torch.Tensor) -> torch.Tensor:
    """:func:`ss2d_sp`'s arithmetic on n H-shards stacked on the leading
    axis of x (n, B, H/n, W, C) in one process: returns the (n, B, H/n, W,
    C) shards of the op's output."""
    with sp_stacked(x.shape[0]):
        return op(x.flatten(0, 1)).unflatten(0, (x.shape[0], -1))
