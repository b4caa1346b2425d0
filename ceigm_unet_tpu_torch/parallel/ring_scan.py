"""Sequence-parallel (context-parallel) first-order scan across ranks.

Counterpart of ``ceigm_unet_tpu/parallel/ring_scan.py``. The combine of
h_t = a_t * h_{t-1} + b_t is associative, so the sequence axis can be
sharded exactly: each shard scans locally, the shards exchange their
(total decay, final state) pair, and each shard folds in the exclusive
prefix of its predecessors. The JAX package does this under ``shard_map``
over a mesh axis; here the shards live on the ranks of a process group
(:func:`sequence_parallel_scan`), or stacked on a leading axis of one
tensor in one process (:func:`stacked_ring_scan`), which runs the same
arithmetic, so an n-shard ring runs on one card.

Every local scan is :func:`scan_rows` (K11, ``csrc/scan_rows.cu`` on the
card; its plain version on the CPU): a shard's carried-in state folds into
its first drive element, b_0 + a_0 * h_in, and the shard scans again, so
the forward takes two local scans and the backward two more.

The backward is the JAX package's adjoint: the scan in the other direction
of the successor-shifted decay a_{t+1} driven by the cotangent, with the
one-element global shifts exchanged between neighbouring shards.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ceigm_unet_tpu_torch.ops.selective_scan import _bc4, _prep, scan_rows
from ceigm_unet_tpu_torch.parallel import mesh


class _GroupRing:
    """Shards on the ranks of ``group``, each holding (..., L/N)."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.idx = dist.get_rank(group)

    def gather(self, s):
        return mesh.all_gather(s, self.group)

    def pick(self, per_shard):
        return per_shard[self.idx]

    def neighbour(self, edge, fill: float, successor: bool):
        """The edge of shard idx + 1 (``successor``) or idx - 1 on this
        rank; ``fill`` where there is none."""
        src = self.idx + 1 if successor else self.idx - 1
        dst = self.idx - 1 if successor else self.idx + 1
        got = torch.full_like(edge, fill)
        ops = []
        if 0 <= dst < self.n:
            ops.append(dist.P2POp(dist.isend, edge.contiguous(),
                                  dist.get_global_rank(self.group, dst),
                                  self.group))
        if 0 <= src < self.n:
            ops.append(dist.P2POp(dist.irecv, got,
                                  dist.get_global_rank(self.group, src),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got


class _StackedRing:
    """n shards stacked on the leading axis: (n, ..., L/n)."""

    def gather(self, s):
        return s

    def pick(self, per_shard):
        return per_shard

    def neighbour(self, edge, fill: float, successor: bool):
        pad = torch.full_like(edge[:1], fill)
        if successor:
            return torch.cat([edge[1:], pad])
        return torch.cat([pad, edge[:-1]])


def _exclusive_prefix(summ: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(n, ..., 2) shards' (total decay, final state), in shard order ->
    (n, ...) the state each shard receives from the shards the scan visits
    before it."""
    n = summ.shape[0]
    h = torch.zeros_like(summ[0, ..., 1])
    out = [h] * n
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        out[i] = h
        h = summ[i, ..., 0] * h + summ[i, ..., 1]
    return torch.stack(out)


def _ring_scan(a, b, ring, reverse: bool) -> torch.Tensor:
    """The global scan's shard (outside autograd)."""
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    h = scan_rows(a, b)
    summ = ring.gather(torch.stack([a.prod(-1), h[..., -1]], -1))
    h_in = ring.pick(_exclusive_prefix(summ, reverse))
    b = b.clone()
    b[..., 0] += a[..., 0] * h_in
    h = scan_rows(a, b)
    return h.flip(-1) if reverse else h


def _shift(x, ring, successor: bool, fill: float) -> torch.Tensor:
    """One-element global shift along the sharded last axis: x'_t =
    x_{t+1} (``successor``) or x_{t-1}, ``fill`` at the global end."""
    if successor:
        edge = ring.neighbour(x[..., :1], fill, successor=True)
        return torch.cat([x[..., 1:], edge], -1)
    edge = ring.neighbour(x[..., -1:], fill, successor=False)
    return torch.cat([edge, x[..., :-1]], -1)


class _RingScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, ring, reverse):
        h = _ring_scan(a, b, ring, reverse)
        ctx.save_for_backward(a, h)
        ctx.ring, ctx.reverse = ring, reverse
        return h

    @staticmethod
    def backward(ctx, gh):
        """Adjoint of h_t = a_t h_prev(t) + b_t over the global order: g =
        the scan in the other direction of (a successor-shifted, gh); da_t =
        g_t h_prev(t), db_t = g_t."""
        a, h = ctx.saved_tensors
        ring, reverse = ctx.ring, ctx.reverse
        a_next = _shift(a, ring, successor=not reverse, fill=1.0)
        g = _ring_scan(a_next, gh.float(), ring, not reverse)
        h_prev = _shift(h, ring, successor=reverse, fill=0.0)
        return g * h_prev, g, None, None


def _check(a, b):
    if a.shape != b.shape or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise ValueError(f"ring scan: takes float32 a and b of one shape, "
                         f"got {a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")


def sequence_parallel_scan(a: torch.Tensor, b: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None,
                           reverse: bool = False) -> torch.Tensor:
    """Exact distributed scan h_t = a_t h_{t-1} + b_t over the last axis,
    sharded in rank order over ``group`` (the active group by default).

    a, b: this rank's fp32 shard (..., L_local). Returns this rank's shard
    of the global inclusive scan. ``reverse`` scans the global sequence
    back to front. Differentiable in a and b; every rank of the group calls
    it, and its backward, together."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("sequence_parallel_scan: no process group (see "
                           "parallel.init_data_parallel)")
    _check(a, b)
    return _RingScan.apply(a, b, _GroupRing(group), reverse)


def stacked_ring_scan(a: torch.Tensor, b: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """:func:`sequence_parallel_scan`'s arithmetic on n shards stacked on
    the leading axis of one tensor: a, b (n, ..., L/n) -> h (n, ..., L/n),
    shard i holding elements [i L/n, (i+1) L/n) of the global scan (see
    :func:`to_shards`). Differentiable."""
    _check(a, b)
    return _RingScan.apply(a, b, _StackedRing(), reverse)


def to_shards(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., L) -> (n, ..., L/n): the last axis cut into n shards."""
    if x.shape[-1] % n:
        raise ValueError(f"to_shards: {n} shards do not divide L "
                         f"{x.shape[-1]}")
    return x.unflatten(-1, (n, x.shape[-1] // n)).movedim(-2, 0)


def from_shards(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_shards`."""
    return x.movedim(0, -2).flatten(-2)


def selective_scan_sp(u, delta, A, B, C, D=None, delta_bias=None,
                      delta_softplus: bool = False,
                      group: Optional[dist.ProcessGroup] = None,
                      reverse: bool = False) -> torch.Tensor:
    """Sequence-parallel selective scan: ``ops.selective_scan``'s API, with
    u, delta (batch, dim, L_local) and B, C (batch, [G,] N, L_local) this
    rank's shards along L over ``group``. ``reverse`` scans the global
    sequence back to front. The scan elements and the C contraction are
    PyTorch ops on the shard, differentiable through autograd; the scan is
    :func:`sequence_parallel_scan`. Returns y in u's dtype."""
    B4, C4 = _bc4(B), _bc4(C)
    batch, dim, L = u.shape
    G, N = B4.shape[1], A.shape[-1]
    uf, _, a, b = _prep(u, delta, A, B4, delta_bias, delta_softplus)
    h = sequence_parallel_scan(a, b, group, reverse)      # (batch, dim, N, L)
    y = torch.einsum("bgdnl,bgnl->bgdl", h.reshape(batch, G, dim // G, N, L),
                     C4.float()).reshape(batch, dim, L)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    return y.to(u.dtype)


def selective_scan_sp_check(device=None) -> None:
    """The multi-process dry run's check: a selective scan with L sharded
    over the active group's ranks (64 elements each) against the unsharded
    op on every rank's device. Raises on a mismatch (rtol 1e-4, atol
    1e-4)."""
    import numpy as np

    from ceigm_unet_tpu_torch.ops.selective_scan import selective_scan
    rank, n = mesh.rank_and_size()
    dev = mesh.rank_device(device or "cpu")
    rng = np.random.default_rng(7)
    batch, dim, N, L = 2, 8, 1, 64 * n
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = t(rng.standard_normal((batch, dim, L)))
    delta = t(0.4 * rng.standard_normal((batch, dim, L)))
    A = t(-0.5 - rng.random((dim, N)))
    B = t(rng.standard_normal((batch, 1, N, L)))
    C = t(rng.standard_normal((batch, 1, N, L)))
    part = slice(rank * 64, (rank + 1) * 64)
    with torch.no_grad():
        y = selective_scan_sp(u[..., part], delta[..., part], A,
                              B[..., part], C[..., part], delta_softplus=True)
        got = mesh.all_gather(y).movedim(0, -2).flatten(-2)
        want = selective_scan(u, delta, A, B, C, delta_softplus=True)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(
            f"selective_scan_sp_check: max abs err "
            f"{(got - want).abs().max().item():.3e} on rank {rank} of {n}")
