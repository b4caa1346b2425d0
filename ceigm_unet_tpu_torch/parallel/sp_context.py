"""Context that routes the model's QuadGroupSS2D blocks through the
H-sharded scan island.

Counterpart of ``ceigm_unet_tpu/parallel/sp_context.py``. The JAX package
enters :func:`sp_scan_island` while tracing, and each QuadGroupSS2D then
runs :func:`ceigm_unet_tpu.parallel.sp_ss2d.quad_group_ss2d_sp` inside
``shard_map`` over a mesh axis. Here the context holds the
``torch.distributed`` group over which H is sharded; under it, every
``QuadGroupSS2D.scan_groups`` (``models/ss2d.py``: the block's forward, and
the scan inside ``GroupMambaLayer``'s) takes its input as this rank's
H-shard and runs :func:`ceigm_unet_tpu_torch.parallel.sp_ss2d.
quad_group_ss2d_sp` over that group:

    with sp_scan_island():              # the active group
        y_shard = block(x_shard)         # (B, H/n, W, C) -> (B, H/n, W, C)

The group is kept in a ``ContextVar``, so nested use restores the previous
value and each thread sees its own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch.distributed as dist

from ceigm_unet_tpu_torch.parallel import mesh

_ACTIVE: contextvars.ContextVar[Optional[dist.ProcessGroup]] = \
    contextvars.ContextVar("sp_scan_island", default=None)


@contextlib.contextmanager
def sp_scan_island(group: Optional[dist.ProcessGroup] = None):
    """Route QuadGroupSS2D through the H-sharded island over ``group``
    (the active group by default) inside this block. Raises when there is
    no group."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("sp_scan_island: no process group to shard H "
                           "over (see parallel.init_data_parallel)")
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[dist.ProcessGroup]:
    """The group of the innermost :func:`sp_scan_island`, else None."""
    return _ACTIVE.get()
