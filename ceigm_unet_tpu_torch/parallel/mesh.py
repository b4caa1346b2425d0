"""Process groups for data-parallel training.

Counterpart of ``ceigm_unet_tpu/parallel/mesh.py``. The JAX package shards
the batch over a 1-D device mesh and XLA inserts every reduction over the
sharded batch axis. Here one process per card joins a ``torch.distributed``
group (:func:`init_data_parallel`), takes its contiguous rows of each global
batch (:func:`shard_batch`), and the port reduces over the group wherever
the JAX step reduces over the batch axis, so that each rank computes what
JAX computes on the global batch:

- BatchNorm's training statistics: the global mean and biased variance
  (``models/layers.py``), hence the same running statistics on every rank;
- the DiceCE loss: the Dice term's per-class sums and the cross-entropy's
  mean over the global batch (``losses.py``);
- the random draws: DropPath's masks and the on-device augmentation's
  parameters are drawn for the global batch on every rank from the same
  generator, and each rank keeps its rows (:func:`global_rows`), so one
  process draws what N processes draw;
- the gradients (``train/trainstep.py``).

Loss convention: every rank computes the global loss. Each cross-rank
reduction is :func:`all_reduce_sum`, whose backward all-reduces the
cotangent, so each rank's backward yields N times its share of the global
gradient (each path from a rank's parameters to the loss crosses the loss's
own reduction once); the train step therefore averages the gradients over
the ranks: their sum over the group divided by N.

Every reduction runs whenever a group is active (:func:`active_group`),
world size 1 included; without one the code computes what it computes on
one device. Inference reduces nothing over the group: eval-mode BatchNorm
reads its running statistics and no loss is taken (the int8 route's
activation scales stay per rank's batch, as they are per batch).

:func:`watch_collectives` counts every ``torch.distributed`` call made in
a block.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

def active_group() -> Optional[dist.ProcessGroup]:
    """The default process group when one is initialised, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_and_size() -> Tuple[int, int]:
    """(rank, world size) in the active group; (0, 1) without one."""
    if active_group() is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_data_parallel(n: Optional[int],
                       device: Union[str, torch.device] = "cuda",
                       rank: Optional[int] = None,
                       store_path: Optional[str] = None,
                       timeout_s: float = 1800.0) -> int:
    """Start the data-parallel group of ``n`` processes, or join the one
    already started; returns this process's rank.

    - A group already initialised (by an earlier call) is checked and kept.
    - With ``store_path``, the ranks meet through a ``FileStore`` at that
      path; ``rank`` is this process's (0 by default when ``n`` is 1).
    - Otherwise the group is torchrun's (``env://``: ``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); ``n`` None takes
      its size as given (the training CLIs' ``--distributed``).

    The backend is NCCL on the card and gloo on the CPU. On the card each
    rank takes ``cuda:<LOCAL_RANK>`` (``cuda:<rank>`` without torchrun) as
    its current device. Raises when the world size is not ``n`` (a smaller
    group would fake data parallelism), when the card is asked for without
    CUDA, when there is neither a store nor torchrun's environment, or when
    the card has fewer devices than the ranks on this host. A collective
    that waits longer than ``timeout_s`` raises."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_data_parallel: NCCL needs CUDA, and this "
                           "process sees no CUDA device")
    if n is None and store_path is not None:
        raise ValueError("init_data_parallel: a FileStore group needs its "
                         "size n")
    if active_group() is None:
        timeout = datetime.timedelta(seconds=timeout_s)
        if store_path is None and "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "init_data_parallel: no store_path and no torchrun "
                "environment (WORLD_SIZE unset); start the ranks with "
                "torchrun --nproc_per_node=N ... --distributed")
        if store_path is not None:
            rank = 0 if rank is None and n == 1 else rank
            if rank is None:
                raise ValueError("init_data_parallel: a FileStore group "
                                 "needs this process's rank")
            store = dist.FileStore(store_path, n)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=n, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
    size = dist.get_world_size()
    if n is not None and size != n:
        raise ValueError(f"init_data_parallel({n}): the group has {size} "
                         f"process(es); a group of another size would "
                         f"fake {n}-way data parallelism")
    rank = dist.get_rank()
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_data_parallel: rank {rank} needs cuda:{local}, this "
                f"host has {torch.cuda.device_count()} device(s)")
        torch.cuda.set_device(local)
    return rank


def close_data_parallel() -> None:
    """Leave the active group, if there is one (a process that joined one
    calls this before it exits)."""
    if active_group() is not None:
        dist.destroy_process_group()


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """This rank's device: on the card ``cuda:<current>`` (the one
    :func:`init_data_parallel` set), else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous rows of every tensor of a global ``batch``
    (rank r of N keeps rows [r*B/N, (r+1)*B/N)); the batch itself without a
    group. Raises when N does not divide the batch."""
    rank, size = rank_and_size()
    out = {}
    for k, t in batch.items():
        if t.shape[0] % size:
            raise ValueError(f"shard_batch: {size} ranks do not divide the "
                             f"batch of {t.shape[0]} ({k!r})")
        b = t.shape[0] // size
        out[k] = t[rank * b:(rank + 1) * b]
    return out


def global_rows(local: int) -> Tuple[int, int]:
    """(global batch, first row of this rank) for a rank holding ``local``
    rows: a random draw of the global batch's size, sliced at
    [first, first + local), gives every rank its rows of what one process
    draws."""
    rank, size = rank_and_size()
    return local * size, rank * local


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over the active group (outside autograd)."""
    dist.all_reduce(t)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(N, *t.shape): every rank's ``t`` in rank order, over ``group`` (the
    default group if None; outside autograd)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def broadcast_flag(flag: bool, device: Union[str, torch.device]) -> bool:
    """Rank 0's ``flag`` on every rank (itself without a group)."""
    if active_group() is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangent over the group
    (see the module docstring's loss convention)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active group, differentiable; ``x`` itself
    without a group."""
    if active_group() is None:
        return x
    return _AllReduceSum.apply(x)


def reduce_gradients(params) -> None:
    """Average the ``.grad`` of ``params`` over the active group: one
    all-reduce per dtype of a flat copy, divided by the world size."""
    if active_group() is None:
        return
    size = dist.get_world_size()
    buckets: Dict[torch.dtype, list] = {}
    for p in params:
        buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat).div_(size)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()


@contextlib.contextmanager
def watch_collectives():
    """Counts every ``torch.distributed`` collective and point-to-point
    batch called inside the block, by function name, in the yielded dict.
    ``isend`` / ``irecv`` are left as they are: ``batch_isend_irecv``, the
    port's one way to send point to point, tells them apart by identity."""
    names = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "broadcast", "reduce_scatter", "reduce_scatter_tensor",
             "all_to_all", "all_to_all_single", "batch_isend_irecv",
             "send", "recv", "barrier")
    counts: Dict[str, int] = {}
    saved = {k: getattr(dist, k) for k in names if hasattr(dist, k)}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    try:
        for k, fn in saved.items():
            setattr(dist, k, counted(k, fn))
        yield counts
    finally:
        for k, fn in saved.items():
            setattr(dist, k, fn)
