"""The whole MSVM-UNet on an image sharded over H: the forward and the
DiceCE loss with its parameter gradients, for the GroupMamba model
(``MSVMUNet``) and the legacy VMamba one (``MSVMUNetLegacy``).

Counterpart of ``ceigm_unet_tpu/parallel/sp_model.py``, the scale-out for
512²-class images, where the image and not only the batch is cut across
cards. The JAX package jits the model with its input H-sharded and lets
GSPMD insert every halo and collective, with the scan on its ``shard_map``
island. Here the model runs under ``parallel/sp_context.py``'s context,
which routes each op that reads across rows or reduces over H:

- the scan: ``QuadGroupSS2D.scan_groups`` -> ``parallel/sp_ss2d.py``'s
  island (K11 on the ring scan; H <-> W all-to-alls), and the legacy
  ``SS2D`` -> ``sp_ss2d.ss2d_scan`` (its four directions over all channels
  on the same ring; one all-to-all each way);
- every spatial conv (the Stem, ``DownSample``, Pvt2Ffn's depthwise conv,
  SAB's 3/7/11, EUCB2's depthwise 3x3, DySample's dilated offset conv):
  ``layers.Conv2d`` -> a zero-filled row halo;
- CustomFfn (K3): 4 rows of x each side, with no rows beyond the image;
- the SE pool and MultiScaleCAB's pools: sums, maxima and minima over the
  shards;
- LGAG in eval (K5): a 2-row halo of g;
- DySample (K4): the source map all-gathered over H (its offsets are
  unbounded, so a sample may read any row; at 512² b8 the largest source
  is (8, 64, 64, 128), 4 MiB in fp32), each shard sampling its own rows
  from the image's base grid;
- the last 4x bilinear upsample: a one-row halo with the border clamp;
- the legacy model's convs (its patch embed, downsamples, the 3/5/7, kx1
  and 5x1 depthwise convs of its MLPs, LKPE's and FLKPE's depthwise 3x3)
  take the same row halo; ``VSSM``'s optional ``pos_embed`` adds each
  shard's own rows; ``PatchMerging2D`` merges each shard's row pairs.

No op falls back to the unsharded model and no other map is gathered: an op
that cannot run sharded raises, and before the forward runs, so does a
model that holds a module class the context neither routes nor knows to be
local (:func:`check_model`), so that an op with no route cannot run per
shard and return wrong logits. n shards must divide every stage's map (H /
4 to H / 32, and W likewise, which the scans re-shard): at 512² n in {2,
4, 8} does; at 224², whose stage 4 is 7x7, no n > 1 does but 7. A stride-2
conv raises when the shard's rows are odd.

Eval mode only: BatchNorm reads its running statistics, LGAG takes its
folded gate and DropPath is the identity. The JAX package's
``sp_value_and_grad`` takes its gradient so too (``model.apply`` with
``train`` at False) and its ``sp_forward(train=True)`` raises (flax refuses
to update ``batch_stats``); here both raise ``ValueError`` for a model in
training mode. JAX's ``scan_island=False`` (plain GSPMD) has no
counterpart.

Two forms, one body of code: on a ``torch.distributed`` group
(:func:`sp_forward`, :func:`sp_value_and_grad`; each rank holds its H-shard
(B, H/n, W, C) in rank order) and on n shards stacked in one process
(:func:`sp_forward_stacked`, :func:`sp_value_and_grad_stacked`; (n, B,
H/n, W, C)), which run as (n*B, H/n, W, C) inside the model.

Gradient convention: the losses (``losses.py``) sum over ``mesh``'s active
group, and every rank computes the global loss; the backward of each of
those sums all-reduces its cotangent, so each rank holds n times its
shard's share of every parameter's gradient, and the mean over the ranks
(``mesh.reduce_gradients``' convention) is the gradient. Every exchange's
backward is its adjoint, so the shares add up whatever the exchange. The
group H is sharded on must therefore be the losses' group.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.parallel.sp_context import sp_scan_island, sp_stacked


def _sharded_classes() -> frozenset:
    """Every module class the H-sharded context runs: the routed ones read
    across rows or reduce over H and take their exchanges under the
    context; the local ones compute each row from that row alone (in eval
    mode), or only call other modules."""
    from torch import nn

    from ceigm_unet_tpu_torch.models import (emcad, groupmamba, layers,
                                             msvm_unet, ss2d, vmamba)
    routed = {layers.Conv2d, layers.CustomFfn, ss2d.QuadGroupSS2D,
              ss2d.SS2D, groupmamba.GroupMamba, groupmamba.GroupMambaLayer,
              emcad.LGAG, emcad.MultiScaleCAB, emcad.DySample, emcad.EMCAD,
              vmamba.VSSM, vmamba.PatchMerging2D}
    local = {nn.Sequential, nn.ModuleList, nn.Identity, nn.ReLU,
             layers.Linear, layers.LayerNorm, layers.BatchNorm2d,
             layers.DropPath, layers.DwConv, layers.Pvt2Ffn,
             layers.InceptionDWConvMultiScale, ss2d.SS2DGroup,
             groupmamba.BlockMamba, groupmamba.Stem, groupmamba.DownSample,
             emcad.SAB, emcad.ParallelAttentionFusion,
             emcad.SplitChannelsOddEven, emcad.EUCB2, emcad._CmLayer,
             emcad.Front, msvm_unet.MSVMUNet, msvm_unet._Encoder,
             vmamba.Gelu, vmamba.InceptionDWConv2dBands, vmamba.MsMlp,
             vmamba.Mlp, vmamba.VSSBlock, vmamba.VSSLayer, vmamba.MSVSS,
             vmamba.LKPE, vmamba.FLKPE, vmamba.UpBlock, vmamba.LegacyDecoder,
             vmamba.MSVMUNetLegacy}
    return frozenset(routed | local)


def check_model(model, what: str) -> None:
    """Raise ``ValueError`` unless ``model`` is an ``MSVMUNet`` or an
    ``MSVMUNetLegacy`` in eval mode whose every module is of a class that
    the H-sharded context routes or knows to be local."""
    from ceigm_unet_tpu_torch.models import MSVMUNet, MSVMUNetLegacy
    if type(model) not in (MSVMUNet, MSVMUNetLegacy):
        raise ValueError(f"{what}: takes an MSVMUNet or an MSVMUNetLegacy, "
                         f"got {type(model).__name__}")
    if model.training:
        raise ValueError(
            f"{what}: the model is in training mode; the H-sharded model "
            f"runs in eval mode only (BatchNorm's running statistics, no "
            f"drop-path), as the JAX package's sp_forward(train=True) "
            f"raises. Call model.eval() first")
    known = _sharded_classes()
    for name, m in model.named_modules():
        if type(m) not in known:
            raise ValueError(
                f"{what}: module {name} is a {type(m).__qualname__}, which "
                f"has no H-sharded route; on shards it would compute each "
                f"shard alone")


def _group(group, what: str):
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError(f"{what}: no process group to shard H over (see "
                           f"parallel.init_data_parallel)")
    return group


def sp_forward(model, x: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``model`` (an ``MSVMUNet`` or ``MSVMUNetLegacy`` in eval mode; see
    :func:`check_model`) on this rank's H-shard x
    (B, H/n, W, 1|3) of an image sharded in rank order over ``group`` (the
    active group by default): returns this rank's logits shard (B, H/n, W,
    classes). Every rank of the group calls it together; differentiable."""
    group = _group(group, "sp_forward")
    check_model(model, "sp_forward")
    with sp_scan_island(group):
        return model(x)


def sp_forward_stacked(model, x: torch.Tensor) -> torch.Tensor:
    """:func:`sp_forward`'s arithmetic on n H-shards stacked in one process:
    x (n, B, H/n, W, 1|3) -> logits (n, B, H/n, W, classes)."""
    check_model(model, "sp_forward_stacked")
    n = x.shape[0]
    with sp_stacked(n):
        return model(x.flatten(0, 1)).unflatten(0, (n, -1))


def _named_grads(model, loss) -> Dict[str, torch.Tensor]:
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named, grads)}


def sp_value_and_grad(model, x: torch.Tensor, labels: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None,
                      ce_weight: float = 0.4, dc_weight: float = 0.6
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DiceCE loss of ``model`` (eval mode) on the image whose H-shards
    the ranks of ``group`` hold (x (B, H/n, W, 1|3), labels (B, H/n, W)
    this rank's), and the gradient of every parameter that requires grad,
    by name: ``(loss, {name: grad})``, both the same on every rank and
    equal to the unsharded model's. ``group`` must be ``mesh``'s active
    group, over which the losses sum."""
    group = _group(group, "sp_value_and_grad")
    if dist.get_process_group_ranks(group) != \
            dist.get_process_group_ranks(mesh.active_group()):
        raise ValueError("sp_value_and_grad: H must be sharded over the "
                         "active group, over which the losses sum")
    from ceigm_unet_tpu_torch.losses import dice_ce_loss
    logits = sp_forward(model, x, group)
    loss = dice_ce_loss(logits, labels, ce_weight=ce_weight,
                        dc_weight=dc_weight)
    grads = _named_grads(model, loss)
    # n times each rank's share: the mean over the ranks, in one all-reduce
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, start = {}, 0
    for k, g in grads.items():
        out[k] = flat[start:start + g.numel()].view_as(g)
        start += g.numel()
    return loss.detach(), out


def sp_value_and_grad_stacked(model, x: torch.Tensor, labels: torch.Tensor,
                              ce_weight: float = 0.4, dc_weight: float = 0.6
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """:func:`sp_value_and_grad` on n H-shards stacked in one process: x
    (n, B, H/n, W, 1|3), labels (n, B, H/n, W). The loss is taken on the
    image the shards make up, and the backward gives the gradient itself
    (one process holds every share)."""
    from ceigm_unet_tpu_torch.losses import dice_ce_loss
    image = lambda t: t.movedim(0, 1).flatten(1, 2)
    logits = sp_forward_stacked(model, x)
    loss = dice_ce_loss(image(logits), image(labels), ce_weight=ce_weight,
                        dc_weight=dc_weight)
    return loss.detach(), _named_grads(model, loss)
