"""Backward by recomputation: the vector-Jacobian product of a plain
PyTorch function, as the JAX package's custom VJPs take ``jax.vjp`` of their
XLA reference functions."""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def recompute_vjp(fn: Callable, args: Sequence, needs_grad: Sequence[bool],
                  go: torch.Tensor) -> tuple:
    """Grads of ``fn(*args)`` for cotangent ``go``: one entry per argument,
    None where ``needs_grad`` is False or the argument is no tensor."""
    with torch.enable_grad():
        ins = [a.detach().requires_grad_(n) if isinstance(a, torch.Tensor)
               else a for a, n in zip(args, needs_grad)]
        wrt = [a for a, n in zip(ins, needs_grad)
               if n and isinstance(a, torch.Tensor)]
        grads = iter(torch.autograd.grad(fn(*ins), wrt, go,
                                         allow_unused=True))
    return tuple(next(grads) if n and isinstance(a, torch.Tensor) else None
                 for a, n in zip(args, needs_grad))
