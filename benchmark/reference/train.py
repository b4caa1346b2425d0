"""Plain reference of the Synapse recipe's training step: DiceCE (CE 0.4,
Dice 0.6) on the reference forward in training mode, its backward by
autograd, and AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay
on every parameter) at the per-epoch cosine LR, all in float32. It imports
neither JAX nor the served package."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import msvm_unet

BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def is_parameter(name: str) -> bool:
    return not name.endswith(BUFFER_SUFFIXES)


def dice_ce(logits: torch.Tensor, labels: torch.Tensor, ce_weight: float,
            dc_weight: float) -> torch.Tensor:
    """CE (mean over pixels) * ce_weight + soft Dice (per class over the
    whole batch, smooth 1e-5, averaged over every class) * dc_weight."""
    C = logits.shape[-1]
    logits = logits.float()
    onehot = F.one_hot(labels.long(), C).float()
    ce = -(torch.log_softmax(logits, -1) * onehot).sum(-1).mean()
    probs = torch.softmax(logits, -1)
    inter = (probs * onehot).sum((0, 1, 2))
    denom = (probs * probs).sum((0, 1, 2)) + onehot.sum((0, 1, 2))
    dice = (1.0 - (2.0 * inter + 1e-5) / (denom + 1e-5)).mean()
    return ce * ce_weight + dice * dc_weight


def cosine_lr(recipe: Dict, step: int) -> float:
    """The LR of optimizer step ``step`` (0-based): cosine annealing
    stepped once per epoch."""
    epoch = step // recipe["steps_per_epoch"]
    lo, hi = recipe["eta_min"], recipe["lr"]
    return lo + (hi - lo) * 0.5 * (1.0 + math.cos(
        math.pi * epoch / recipe["t_max"]))


class AdamW:
    """AdamW as the recipe sets it, element by element."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moments: Optional[Dict] = None):
        """``moments``, if given, resumes an optimizer: its ``exp_avg`` and
        ``exp_avg_sq`` by name and the ``steps`` it has taken."""
        self.params, self.wd, self.betas, self.eps = params, weight_decay, \
            betas, eps
        moments = moments or {}
        start = lambda key, k, v: moments[key][k].to(v).clone() \
            if key in moments else torch.zeros_like(v)
        self.m = {k: start("exp_avg", k, v) for k, v in params.items()}
        self.v = {k: start("exp_avg_sq", k, v) for k, v in params.items()}
        self.t = moments.get("steps", 0)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(state: Dict[str, torch.Tensor], batches: Sequence[Dict],
                depths: Sequence[int], recipe: Dict,
                generator: torch.Generator,
                P: msvm_unet.Precision = msvm_unet.FP32,
                moments: Optional[Dict] = None) -> Dict:
    """Run len(batches) unfrozen training steps from ``state`` (left
    unchanged). Returns each step's loss, the first step's logits, every
    parameter's first gradient and its change over the steps, by name.
    ``generator`` draws the stochastic-depth masks, step after step, as the
    served step draws them. ``moments`` resumes AdamW after that many
    steps (see ``AdamW``); the LR follows the schedule from there."""
    params = {k: v.detach().float().clone() for k, v in state.items()
              if is_parameter(k)}
    start = {k: v.clone() for k, v in params.items()}
    buffers = {k: v.float() for k, v in state.items() if not is_parameter(k)}
    opt = AdamW(params, recipe["weight_decay"], moments=moments)
    done = opt.t
    losses: List[float] = []
    first_grads = first_logits = None
    names = list(params)
    for i, batch in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        p = {**buffers, **leaves}
        image = batch["image"]
        masks = msvm_unet.draw_masks(image.shape[0], recipe["drop_path_rate"],
                                     generator)
        logits = msvm_unet.forward(p, image, depths, train=True, masks=masks,
                                   P=P, ckpt=True)
        loss = dice_ce(logits, batch["label"], recipe["ce_weight"],
                       recipe["dc_weight"])
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        if i == 0:
            first_logits = logits.detach().cpu()
        del logits, loss, p, leaves
        for v in params.values():
            v.requires_grad_(False)
        if first_grads is None:
            first_grads = grads
        opt.step(grads, cosine_lr(recipe, done + i))
    change = {k: params[k] - start[k] for k in names}
    return {"losses": losses, "first_grads": first_grads, "change": change,
            "first_logits": first_logits}
