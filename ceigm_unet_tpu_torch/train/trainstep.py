"""Training step: forward in training mode, loss, backward, optimizer step.

Counterpart of ``ceigm_unet_tpu/train/trainstep.py``. One call covers the
forward (BatchNorm on batch statistics, running statistics updated,
stochastic depth from the caller's generator), the DiceCE loss, the
backward, the optimizer step at the LR the per-epoch schedule gives, and the
encoder freeze.

Freeze semantics: while frozen, the encoder gets zero gradients and zero
updates (no weight decay; its optimizer moments stay exactly 0), and the
optimizer's step count still advances, so Adam's bias correction counts
every step (``docs/PARITY.md``). Here the encoder's parameters leave
autograd for the step (its backward is not computed; the result is the
same), their grads are set to zeros (not None, so torch.optim counts the
step) and the encoder's param group runs with weight_decay 0. Every other
parameter that got no gradient gets a zero one, as every leaf of a JAX
gradient tree exists.

One divergence from the JAX code, kept on purpose: under an optimizer
with L2 decay inside the gradient (Adam, SGD with momentum, RMSprop, wd >
0) the JAX step zeroes the frozen encoder's grads before ``tx.update``,
and the chain's ``add_decayed_weights`` then feeds wd * p into the
moments (one frozen Adam step at wd 0.1, p = 1 leaves mu 0.01). The port
keeps the reference trainer's semantics (``requires_grad=False``), which
are also what the JAX module's own docstring states: the moments stay 0.
The parameters do not move either way, and AdamW (the live recipe)
decays outside the moments, so it is not affected.

Data parallelism (``parallel/mesh.py``): with a process group active, each
rank steps on its rows of the global batch, computes the global loss (the
loss's and BatchNorm's sums run over the group), and the gradients are
averaged over the group (one all-reduce per dtype) before the optimizer
step, as ``DistributedDataParallel`` would average them; every rank then
holds the same parameters. The module docstring of ``parallel/mesh.py``
gives the loss convention that makes the average the global gradient. The
explicit all-reduce, and not ``DistributedDataParallel``, because the step
toggles ``requires_grad`` on the encoder during the freeze and zero-fills
missing gradients, which DDP's reducer takes only with
``find_unused_parameters``. The device augmentation's parameters are drawn
for the global batch, and each rank keeps its rows.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ceigm_unet_tpu_torch.data.device_aug import (apply_params, sample_params,
                                                  step_generator)
from ceigm_unet_tpu_torch.losses import dice_ce_loss
from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.train.lr_scheduler import cosine_annealing_lr
from ceigm_unet_tpu_torch.utils.spans import span


def cosine_lr(base_lr: float, eta_min: float, t_max: int,
              steps_per_epoch: int) -> Callable[[int], float]:
    """torch CosineAnnealingLR stepped per epoch (reference
    train_synapse.py), in the JAX package's argument order."""
    return cosine_annealing_lr(base_lr, steps_per_epoch, t_max, eta_min)


def param_groups(model: nn.Module) -> List[Dict]:
    """Two param groups: the encoder's (``name="encoder"``, the one the
    freeze acts on) and the rest."""
    if not hasattr(model, "encoder"):
        names = [n for n, _ in model.named_children()]
        raise ValueError("the encoder freeze expects a top-level 'encoder' "
                         f"submodule; got {names}")
    enc = {id(p) for p in model.encoder.parameters()}
    return [{"params": list(model.encoder.parameters()), "name": "encoder"},
            {"params": [p for p in model.parameters() if id(p) not in enc],
             "name": "rest"}]


def make_optimizer(params, weight_decay: float) -> torch.optim.Optimizer:
    """AdamW with torch defaults (betas 0.9/0.999, eps 1e-8), weight decay
    on every parameter as the reference's single group has it."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_adam(params, weight_decay: float = 0.0, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Optimizer:
    """torch Adam: L2 weight decay added to the gradient before the moment
    updates (unlike AdamW's decoupled decay)."""
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def make_sgd(params, weight_decay: float = 0.0, momentum: float = 0.0,
             nesterov: bool = False) -> torch.optim.Optimizer:
    """torch SGD: grad += wd * p, then the optional momentum buffer."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


def make_rmsprop(params, weight_decay: float = 0.0, alpha: float = 0.99,
                 eps: float = 1e-8) -> torch.optim.Optimizer:
    """torch RMSprop: grad += wd * p; divide by sqrt(sq_avg) + eps (eps
    outside the square root)."""
    return torch.optim.RMSprop(params, lr=0.0, alpha=alpha, eps=eps,
                               weight_decay=weight_decay)


# Reference knob set (gm-unet/train_synapse.py); live entry: AdamW.
OPTIMIZERS = {
    "Adam": make_adam,
    "SGD": make_sgd,
    "RMSprop": make_rmsprop,
    "AdamW": make_optimizer,
}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    ce_weight: float = 0.4, dc_weight: float = 0.6,
                    device_aug_size: Optional[int] = None,
                    aug_seed: int = 0):
    """Returns ``step(batch, freeze_encoder=False, generator=None) ->
    {"loss"}``; batch = {"image": (B, H, W, 1|3), "label": (B, H, W)} on the
    model's device. ``optimizer`` holds :func:`param_groups` (its
    ``"encoder"`` group is the one frozen). The step count, which the LR
    schedule reads, is ``step.count``.

    With ``device_aug_size`` the batch holds raw slices instead (not
    augmented, not normalised, at their source size: image (B, H, W, 1)
    float32, label (B, H, W) int), and the step runs the on-device
    augmentation (``data/device_aug.py``: the SomeOf((0, 4)) policy and the
    zoom to ``device_aug_size`` in one gather), then (x - 0.5) / 0.5, before
    the forward. Its parameters come from a generator on the batch's device
    seeded from (``aug_seed``, ``step.count``), so a step's augmentation
    depends only on those and the (global) batch size.

    With a data-parallel group active the batch is this rank's rows of the
    global batch, the returned loss is the global batch's, and the
    gradients are averaged over the group before the optimizer steps (see
    the module docstring).

    Spans (``utils/spans.py``, recorded only under a profiler): one
    ``train_step`` per call, its request ``step.count``, with the count
    ``samples`` (this rank's rows); inside it, in order,
    ``train_step.prepare`` (the LR and weight-decay writes, ``zero_grad``,
    the encoder's ``requires_grad_`` toggles), ``train_step.augment`` (with
    ``device_aug_size`` only), ``.forward``, ``.loss``, ``.backward``,
    ``.fill`` (missing gradients zero-filled),
    ``.reduce`` and ``.optimizer``."""
    loss_fn = functools.partial(dice_ce_loss, ce_weight=ce_weight,
                                dc_weight=dc_weight)
    enc = [g for g in optimizer.param_groups if g.get("name") == "encoder"]
    if len(enc) != 1:
        raise ValueError("the optimizer needs one param group named "
                         "'encoder' (see param_groups)")
    enc = enc[0]
    weight_decay = enc["weight_decay"]
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, freeze_encoder: bool = False,
             generator: Optional[torch.Generator] = None):
        image, label = batch["image"], batch["label"]
        with span("train_step", request=step.count,
                  samples=label.shape[0]):
            with span("train_step.prepare"):
                model.train()
                lr = lr_schedule(step.count)
                for g in optimizer.param_groups:
                    g["lr"] = lr
                enc["weight_decay"] = 0.0 if freeze_encoder else weight_decay
                optimizer.zero_grad(set_to_none=True)
                for p in enc["params"]:
                    p.requires_grad_(not freeze_encoder)
            try:
                if device_aug_size is not None:
                    with span("train_step.augment"):
                        gen = step_generator(aug_seed, step.count,
                                             image.device)
                        B, H, W = label.shape
                        total, first = mesh.global_rows(B)
                        prm = sample_params(gen, total, H, W,
                                            device_aug_size, image.device)
                        img, label = apply_params(
                            {k: v[first:first + B] for k, v in prm.items()},
                            image[..., 0], label, device_aug_size)
                        image = ((img - 0.5) / 0.5)[..., None]
                with span("train_step.forward"):
                    logits = model(image, generator=generator)
                with span("train_step.loss"):
                    loss = loss_fn(logits, label)
                del logits          # not held through the backward
                with span("train_step.backward"):
                    loss.backward()
            finally:
                for p in enc["params"]:
                    p.requires_grad_(True)
            with span("train_step.fill"):
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            with span("train_step.reduce"):
                mesh.reduce_gradients(params)
            with span("train_step.optimizer"):
                optimizer.step()
        step.count += 1
        return {"loss": loss.detach()}

    step.count = 0
    return step
