"""Context that runs the model on H-shards: the scan island and every
exchange of the H-sharded model.

Counterpart of ``ceigm_unet_tpu/parallel/sp_context.py``. The JAX package
enters :func:`sp_scan_island` while tracing, and each QuadGroupSS2D then
runs :func:`ceigm_unet_tpu.parallel.sp_ss2d.quad_group_ss2d_sp` inside
``shard_map`` over a mesh axis; GSPMD shards every other op. Here the
context holds the shard ring (``parallel/ring_scan.py``) over which H is
sharded, and every op that reads across rows or reduces over H takes its
input as the shard and exchanges what it needs over that ring:
``QuadGroupSS2D.scan_groups`` (``models/ss2d.py``: the block's forward, and
the scan inside ``GroupMambaLayer``'s) runs the island
(``parallel/sp_ss2d.py``), and the model's convs, pools, gates, upsamplers
and its last upsample run the exchanges of ``parallel/sp_ops.py``:

    with sp_scan_island():              # the active group
        y_shard = block(x_shard)         # (B, H/n, W, C) -> (B, H/n, W, C)

    with sp_stacked(n):                 # n shards in one process
        y = model(x_stacked)            # (n*B, H/n, W, C): shard-major

Under :func:`sp_scan_island` the shards live on the ranks of a
``torch.distributed`` group, one per rank; under :func:`sp_stacked` they
ride in the batch axis of one tensor, shard i holding images [i*B, (i+1)*B)
of the batch, and every exchange views them as (n, B, ...). The ring is
kept in a ``ContextVar``, so nested use restores the previous value and
each thread sees its own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch.distributed as dist

from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.parallel.ring_scan import _GroupRing, _StackedRing

Ring = Union[_GroupRing, _StackedRing]

_ACTIVE: contextvars.ContextVar[Optional[Ring]] = \
    contextvars.ContextVar("sp_scan_island", default=None)


@contextlib.contextmanager
def _entered(r: Ring):
    token = _ACTIVE.set(r)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def sp_scan_island(group: Optional[dist.ProcessGroup] = None):
    """Run the model's ops on this rank's H-shard over ``group`` (the
    active group by default) inside this block. Raises when there is no
    group."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("sp_scan_island: no process group to shard H "
                           "over (see parallel.init_data_parallel)")
    with _entered(_GroupRing(group)):
        yield


@contextlib.contextmanager
def sp_stacked(n: int):
    """Run the model's ops on n H-shards stacked in the batch axis, (n*B,
    H/n, W, C), inside this block."""
    if n < 1:
        raise ValueError(f"sp_stacked: {n} shards")
    with _entered(_StackedRing(n)):
        yield


def ring() -> Optional[Ring]:
    """The ring of the innermost context, else None."""
    return _ACTIVE.get()


def active() -> Optional[dist.ProcessGroup]:
    """The group of the innermost :func:`sp_scan_island`; None outside one
    and under :func:`sp_stacked`."""
    r = _ACTIVE.get()
    return getattr(r, "group", None)
